"""Synthetic data (no external datasets), the port's own copy of
`repro.data.synthetic`'s `markov_tokens` (order-1 Markov token
sequences, the LM prompts), `lm_batch` (the LM's next-token training
batches), `class_images` (procedurally generated
CIFAR-shaped images with class-dependent texture statistics) and
`seg_batch` (a lane-like segmentation task), seeded per
(seed, shard, step), so a batch is regenerated exactly. numpy only; the
caller moves the arrays to its device.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, shard: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, shard, step]))


def markov_tokens(seed: int, shard: int, step: int, batch: int, seq: int,
                  vocab: int) -> np.ndarray:
    """Order-1 Markov token batch (B, S+1) int32: each token t is followed
    by (a*t + b) mod V with probability 0.8, else by a uniform token."""
    rng = _rng(seed, shard, step)
    a = 6364136223846793005 % vocab or 1
    b = seed % vocab
    out = np.empty((batch, seq + 1), np.int64)
    out[:, 0] = rng.integers(0, vocab, batch)
    greedy = rng.random((batch, seq)) < 0.8
    rand = rng.integers(0, vocab, (batch, seq))
    for i in range(seq):
        nxt = (a * out[:, i] + b) % vocab
        out[:, i + 1] = np.where(greedy[:, i], nxt, rand[:, i])
    return out.astype(np.int32)


def lm_batch(seed: int, shard: int, step: int, batch: int, seq: int,
             vocab: int) -> dict:
    """One LM training batch: tokens (B, S) and their next tokens, the
    labels (B, S), both int32, cut from one (B, S+1) Markov batch."""
    toks = markov_tokens(seed, shard, step, batch, seq, vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def class_images(seed: int, shard: int, step: int, batch: int, img: int = 32,
                 channels: int = 3, n_classes: int = 10) -> dict:
    """Class-conditional textured images (B,H,W,C) in [0,1] + labels."""
    rng = _rng(seed, shard, step)
    labels = rng.integers(0, n_classes, batch)
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32) / img
    imgs = np.empty((batch, img, img, channels), np.float32)
    for i, c in enumerate(labels):
        fx, fy = 1 + c % 5, 1 + c // 5
        base = 0.5 + 0.35 * np.sin(2 * np.pi * (fx * xx + fy * yy))
        noise = rng.normal(0, 0.1, (img, img, channels))
        phase = 2 * np.pi * np.arange(channels) / channels + c
        imgs[i] = np.clip(
            base[..., None] * (0.8 + 0.2 * np.cos(phase)) + noise, 0, 1)
    return {"image": imgs, "label": labels.astype(np.int32)}


def seg_batch(seed: int, shard: int, step: int, batch: int,
              img: int = 64) -> dict:
    """Lane-like segmentation task: diagonal stripe masks (B,H,W) in {0,1}
    over noisy (B,H,W,3) images in [0,1], the lane brightened."""
    rng = _rng(seed, shard, step)
    imgs = rng.normal(0.5, 0.15, (batch, img, img, 3)).astype(np.float32)
    masks = np.zeros((batch, img, img), np.int32)
    yy, xx = np.mgrid[0:img, 0:img]
    for i in range(batch):
        slope = rng.uniform(-1, 1)
        offset = rng.uniform(0.3, 0.7) * img
        width = rng.uniform(2, 6)
        lane = np.abs(yy - (slope * (xx - img / 2) + offset)) < width
        masks[i] = lane
        imgs[i, lane] += 0.4
    return {"image": np.clip(imgs, 0, 1), "mask": masks}
