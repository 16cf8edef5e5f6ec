"""Pipelined frame streaming on CUDA streams with pinned host buffers.

Port of ``fs_uae_image_enhancer_project_tpu/export/streaming.py``. With a
pipeline depth of D, ``submit`` returns the enhanced frame of D calls ago, so
the upload of frame t, the compute of the frames in flight and the readback
of frame t-D overlap. On a card each of the D+1 slots owns a CUDA stream, a
pinned input buffer, a pinned output buffer and an event; a slot is reused
only after its result was read back. On the CPU the same interface runs
synchronously.

Usage (per emulator frame):
    stream = FrameStream(enhance_fn, depth=2, device="cuda")
    out = stream.submit(frame)   # enhanced frame from D frames ago, or None
    ...
    for out in stream.drain():   # flush the tail on shutdown
        ...
"""
from __future__ import annotations

import collections
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .. import FRAME_H, FRAME_W, resolve_device


class FrameStream:
    def __init__(self, enhance_fn: Callable, depth: int = 2, *, device=None,
                 frame_shape=(FRAME_H, FRAME_W, 4)):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.fn = enhance_fn
        self.depth = depth
        self.device = resolve_device(device)
        self.frame_shape = tuple(frame_shape)
        self._inflight: collections.deque = collections.deque()
        self._slots = []
        self._next = 0
        if self.device.type == "cuda":
            pin = dict(dtype=torch.uint8, pin_memory=True)
            for _ in range(depth + 1):
                self._slots.append((
                    torch.cuda.Stream(self.device),
                    torch.empty((1, *self.frame_shape), **pin),
                    torch.empty((1, *self.frame_shape), **pin),
                    torch.cuda.Event(),
                ))

    def submit(self, frame: np.ndarray) -> Optional[np.ndarray]:
        """Enqueue one uint8 RGBA frame; returns the oldest completed result
        once the pipeline is full (None while it fills)."""
        frame = np.asarray(frame, np.uint8)
        if frame.ndim == 3:
            frame = frame[None]
        if not self._slots:  # CPU: synchronous
            self._inflight.append(self.fn(torch.from_numpy(frame)).numpy())
        else:
            if frame.shape[1:] != self.frame_shape:
                raise ValueError(f"frame must be {self.frame_shape}, got {frame.shape[1:]}")
            slot = self._next
            self._next = (slot + 1) % len(self._slots)
            stream, pin_in, pin_out, done = self._slots[slot]
            pin_in.numpy()[...] = frame
            # weights and earlier work on the caller's stream come first
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                y = self.fn(pin_in.to(self.device, non_blocking=True))
                pin_out.copy_(y, non_blocking=True)
                done.record(stream)
            self._inflight.append(slot)
        if len(self._inflight) > self.depth:
            return self._pop()
        return None

    def _pop(self) -> np.ndarray:
        item = self._inflight.popleft()
        if not self._slots:
            return item
        _, _, pin_out, done = self._slots[item]
        done.synchronize()
        return pin_out.numpy().copy()

    def drain(self) -> Iterator[np.ndarray]:
        while self._inflight:
            yield self._pop()

    def __len__(self) -> int:
        return len(self._inflight)
