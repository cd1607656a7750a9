"""Seeded generators: one ``torch.Generator`` per (round seed, epoch, stream,
chunk), as the JAX package folds the epoch into its key.

An epoch's draws depend only on the round seed, the global epoch and the
stream: ``STREAM_INIT`` (the model's initial parameters), ``STREAM_WALKS``
(the epoch's walks, ``sample.walk.PathSampler.sample_epoch``) and
``STREAM_DROPOUT`` (one generator per microbatch chunk).
"""
from __future__ import annotations

from typing import Union

import torch

STREAM_INIT, STREAM_WALKS, STREAM_DROPOUT = 0, 1, 2
_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, epoch: int, stream: int, chunk: int = 0) -> int:
    """A 63-bit seed for one (round seed, epoch, stream, chunk): SplitMix64
    over the four numbers, so neighbouring tuples give unrelated streams."""
    x = 0
    for v in (seed, epoch, stream, chunk):
        x = (x ^ (v & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
        x ^= x >> 31
    return x >> 1


def make_generator(seed: int, epoch: int, stream: int, chunk: int = 0,
                   device: Union[str, torch.device] = "cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, epoch, stream, chunk))
