"""Sample gathering and the training data pipeline.

Port of ``fs_uae_image_enhancer_project_tpu/data/dataset.py``:

- :func:`gather_all_samples_from_directory` walks the generator's output
  tree, groups files by crop location, validates the target sizes and pairs
  every (style-filtered) styled file with its target.
- :class:`SRDataset` draws uniform random pairs with synchronized H/V flips;
  its numpy draws are the JAX package's, so one seed gives the same batches
  byte for byte. Its length is a declared ``num_samples``, not the pool's.
- :func:`batch_transform` turns uint8 batches into fp32 on the device.
- :func:`device_prefetch` keeps batches in flight to the card: a producer
  thread fills pinned host buffers and copies them on a side CUDA stream.
"""
from __future__ import annotations

import os
import queue
import threading
import warnings
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import resolve_device
from .codec import parse_generated_filename

Pair = Tuple[str, str]


def gather_all_samples_from_directory(
    directory_path: str,
    expected_crop_size: Tuple[int, int],
    styles_to_include: Optional[Set[str]] = None,
    verbose: int = 1,
) -> List[Pair]:
    """Collect all (styled_path, target_path) pairs under a generator split.

    Grouping key: (subdirectory relpath, crop_x, crop_y, s<scale>, r<rot>).
    Styled files whose style_name contains any of ``styles_to_include``
    substrings pass the filter. Target sizes are checked against
    ``expected_crop_size`` (W, H); a location whose target differs is dropped.
    """
    if not os.path.isdir(directory_path):
        raise FileNotFoundError(f"Data directory not found: {directory_path}")

    from PIL import Image

    grouped: Dict[tuple, List[dict]] = defaultdict(list)
    root_abs = os.path.abspath(directory_path)
    for root, _dirs, files in os.walk(directory_path):
        if os.path.abspath(root) == root_abs:
            continue  # files live in per-image subdirectories
        # the relative path, not the basename: same-named scene directories
        # in different subtrees must not merge into one group
        dirname = os.path.relpath(root, root_abs)
        for filename in files:
            info = parse_generated_filename(filename)
            if info is None:
                continue
            info["full_path"] = os.path.join(root, filename)
            key = (dirname, info["crop_x"], info["crop_y"], info["scale_part"],
                   info["rot_part"])
            grouped[key].append(info)

    pairs: List[Pair] = []
    for _key, infos in grouped.items():
        target = next((i for i in infos if i["type"] == "target"), None)
        if target is None:
            continue
        styled = [
            i for i in infos
            if i["type"] == "style"
            and (styles_to_include is None
                 or any(s in i["style_name"] for s in styles_to_include))
        ]
        if not styled:
            continue
        try:
            with Image.open(target["full_path"]) as img:
                if img.size != tuple(expected_crop_size):
                    if verbose >= 1:
                        warnings.warn(
                            f"Target {target['full_path']} has size {img.size}, "
                            f"expected {expected_crop_size}. Skipping location.")
                    continue
        except Exception as e:  # an unreadable target drops its location
            if verbose >= 1:
                warnings.warn(f"Could not read target {target['full_path']}: {e}")
            continue
        for s in styled:
            pairs.append((s["full_path"], target["full_path"]))

    if verbose >= 1:
        print(f"Gathered {len(pairs)} sample pairs from {directory_path}")
    return pairs


def split_pairs(pairs: Sequence[Pair], val_ratio: float,
                seed: int = 0) -> Tuple[List[Pair], List[Pair]]:
    """Shuffle and split by ratio, with the reference's one-sample guards."""
    pairs = list(pairs)
    rng = np.random.default_rng(seed)
    rng.shuffle(pairs)
    n = len(pairs)
    val_ratio = min(max(val_ratio, 0.0), 1.0)
    n_val = int(n * val_ratio)
    n_train = n - n_val
    if n > 0:
        if n_train == 0:
            n_train, n_val = 1, n - 1
        if n_val == 0 and val_ratio > 0 and n > 1:
            n_val, n_train = 1, n - 1
    return pairs[:n_train], pairs[n_train:n_train + n_val]


def _load_pair(pair: Pair, linear: bool, hflip: bool, vflip: bool,
               as_uint8: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    from PIL import Image

    out = []
    for path in pair:
        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB"))
        if hflip:
            arr = arr[:, ::-1]
        if vflip:
            arr = arr[::-1]
        if as_uint8:
            # raw bytes; /255 and the gamma run on the device (batch_transform)
            out.append(np.ascontiguousarray(arr))
            continue
        arr = arr.astype(np.float32) / 255.0
        if linear:
            arr = arr**2.2  # sRGB -> linear approximation
        out.append(np.ascontiguousarray(arr))
    return out[0], out[1]


class SRDataset:
    """Random-draw pair dataset with synchronized flips.

    Iterating yields ``num_samples // batch_size`` batches of (lr, hr) NHWC
    numpy arrays an epoch (float32, or uint8 with ``transfer_dtype="uint8"``);
    draws are uniform over the pool whatever the declared epoch size, and a
    failed load retries with the next pair.
    """

    def __init__(
        self,
        sample_pairs_list: Sequence[Pair],
        expected_crop_size: Tuple[int, int],
        num_samples: int,
        *,
        batch_size: int = 1,
        seed: int = 0,
        linear: bool = True,
        flips: bool = True,
        num_workers: int = 4,
        transfer_dtype: str = "float32",
    ):
        if transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype must be float32|uint8, got {transfer_dtype!r}")
        self.pool: List[Pair] = list(sample_pairs_list)
        if not self.pool:
            warnings.warn("SRDataset initialized with an empty sample pool.")
        self.crop_w, self.crop_h = expected_crop_size
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.linear = linear
        self.flips = flips
        self.num_workers = num_workers
        # "uint8": batches stay raw bytes, a quarter of the float32 transfer;
        # batch_transform makes them fp32 on the device. The draws are the
        # same in both modes.
        self.transfer_dtype = transfer_dtype
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.num_samples // self.batch_size

    def _plan_draw(self) -> Tuple[int, bool, bool]:
        """One draw (index and flips); called from one thread only."""
        idx = int(self._rng.integers(0, len(self.pool)))
        hflip = self.flips and bool(self._rng.random() < 0.5)
        vflip = self.flips and bool(self._rng.random() < 0.5)
        return idx, hflip, vflip

    def _load_planned(self, plan: Tuple[int, bool, bool]):
        idx, hflip, vflip = plan
        as_u8 = self.transfer_dtype == "uint8"
        want = (self.crop_h, self.crop_w, 3)
        for _attempt in range(10):
            try:
                lr, hr = _load_pair(self.pool[idx], self.linear, hflip, vflip, as_uint8=as_u8)
                # the gatherer checks targets only: a wrong-size styled file
                # takes the retry path here
                if lr.shape != want or hr.shape != want:
                    raise ValueError(f"pair shape {lr.shape}/{hr.shape}, expected {want}")
                return lr, hr
            except Exception as e:  # retry with the next pair
                warnings.warn(f"Error loading {self.pool[idx]}: {e}. Retrying.")
                idx = (idx + 1) % len(self.pool)
        raise RuntimeError("10 consecutive sample load failures")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self.batches()

    def batches(self, part: int = 0, parts: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The epoch's batches, each cut to its ``part``-th of ``parts``
        equal blocks along the batch axis (a dp rank's share): every draw is
        made, so the stream is the whole batches', and only the block's
        pairs are loaded."""
        if not self.pool:
            raise IndexError("SRDataset pool is empty. Cannot draw samples.")
        if self.batch_size % parts:
            raise ValueError(f"batch {self.batch_size} must be divisible by {parts} parts")
        n = self.batch_size // parts
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            for _ in range(len(self)):
                # every draw of a batch before any load: numpy Generators are
                # not thread-safe, and the stream must not depend on threads
                plans = [self._plan_draw() for _ in range(self.batch_size)]
                items = list(ex.map(self._load_planned, plans[part * n:(part + 1) * n]))
                yield np.stack([a for a, _ in items]), np.stack([b for _, b in items])


def batch_transform(linear: bool):
    """uint8 -> [0, 1] fp32 (then ``**2.2`` when ``linear``) on the tensor's
    device: the float32 loader path's arithmetic for uint8 batches. Float
    tensors pass unchanged, so callers can apply it to either."""

    def apply(x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.uint8:
            return x
        x = x.float() / 255.0
        return x**2.2 if linear else x

    return apply


def device_prefetch(iterator, size: int = 2, device=None):
    """Yield the batches of ``iterator`` (tuples of numpy arrays) as tensors
    on ``device`` (default ``cuda``), with ``size`` batches in flight.

    A producer thread draws the batches. On a card it fills pinned host
    buffers and copies them to the device on a side CUDA stream
    (``non_blocking``); each batch carries an event, which the consumer's
    stream waits on before the batch is used. On ``device="cpu"`` the arrays
    become tensors with no pinning and no copy. When the consumer stops
    early (an exception in the train loop, the generator closed or
    collected) the producer exits and the batches in flight are dropped.
    """
    dev = resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    END = object()
    error: list = []
    stop = threading.Event()

    def put(batch):
        if stream is None:
            return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch), None
        pinned = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in batch]
        with torch.cuda.stream(stream):
            on_dev = tuple(p.to(dev, non_blocking=True) for p in pinned)
            done = torch.cuda.Event()
            done.record(stream)
        return on_dev, done

    def q_put(item) -> bool:
        """A bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not q_put(put(batch)):
                    return  # the consumer is gone
        except BaseException as e:  # re-raised in the consumer
            error.append(e)
        finally:
            q_put(END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                if error:
                    raise error[0]
                break
            tensors, done = item
            if done is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(done)
                for x in tensors:  # allocated on the side stream, used on this one
                    x.record_stream(current)
            yield tensors
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=30)
