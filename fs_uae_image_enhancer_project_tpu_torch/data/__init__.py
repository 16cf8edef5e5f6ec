"""Generated-dataset filename codec (shared by the generator and, with the
training slice, the dataset)."""
from .codec import construct_filename, parse_generated_filename  # noqa: F401
