"""The generated-dataset filename codec and the training data pipeline."""
from .codec import construct_filename, parse_generated_filename  # noqa: F401
from .dataset import (  # noqa: F401
    SRDataset,
    batch_transform,
    device_prefetch,
    gather_all_samples_from_directory,
    split_pairs,
)
