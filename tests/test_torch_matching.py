"""The device ORB matcher in the port against the JAX package's, on the CPU.

Descriptors are drawn from a seed with numpy: random 256-bit rows, some
queries planted as copies of train rows with a few bits flipped (matches
that pass the ratio test), duplicated train rows (a tie for the nearest
place, which must fail the ratio test whichever index comes first) and
queries with two train rows at the same second distance (a tie that only
moves an index nothing reads). The JAX side runs ``match_descriptors_device``
at a small capacity (one XLA compile), or cv2's ``BFMatcher`` above the
capacity, where the JAX package hands inputs to it; the lists must be equal.
"""

import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.ops import matching as jax_matching
from deep_visual_slam_tpu.slam import frontend as jfrontend

from deep_visual_slam_torch.ops import matching

torch.set_num_threads(1)

CAPACITY = 768


def _flip(row: np.ndarray, bits, rng) -> np.ndarray:
    out = np.unpackbits(row.copy())
    idx = rng.choice(256, size=bits, replace=False)
    out[idx] ^= 1
    return np.packbits(out)


def _descriptors(seed: int, n1: int, n2: int):
    rng = np.random.default_rng(seed)
    des2 = rng.integers(0, 256, size=(n2, 32), dtype=np.uint8)
    des1 = rng.integers(0, 256, size=(n1, 32), dtype=np.uint8)
    for q in range(0, n1, 3):  # planted matches, 0-20 bits apart
        des1[q] = _flip(des2[(7 * q) % n2], int(rng.integers(0, 21)), rng)
    for q in range(1, n1, 9):  # a tie for the nearest: a duplicated train row
        t = (5 * q) % (n2 - 1)
        des2[t + 1] = des2[t]
        des1[q] = _flip(des2[t], 3, rng)
    for q in range(2, n1, 11):  # a tie for the second place
        t = (3 * q) % (n2 - 2)
        des1[q] = des2[t]
        des2[t + 1] = _flip(des2[t], 12, rng)
        des2[t + 2] = _flip(des2[t], 12, rng)
    return des1, des2


@pytest.mark.parametrize("sizes", [(700, 760), (CAPACITY, 5), (2, 2)])
def test_matcher_matches_jax(sizes):
    des1, des2 = _descriptors(sum(sizes), *sizes)
    want = jax_matching.match_descriptors_device(des1, des2, capacity=CAPACITY)
    got = matching.match_descriptors_device(des1, des2, capacity=CAPACITY, device="cpu")
    assert tuple(got) == tuple(want)
    if sizes[0] == 700:
        assert len(got[0]) > 150  # the planted matches came through


def test_matcher_above_capacity_matches_cv2():
    """3100 x 3100 planted descriptors at the default capacity (3072), which
    the JAX package hands to cv2's ``BFMatcher``: the same lists."""
    des1, des2 = _descriptors(3100, 3100, 3100)
    want = jfrontend.match_descriptors_cv2(des1, des2)
    got = matching.match_descriptors_device(des1, des2, device="cpu")
    assert tuple(got) == tuple(want)
    assert len(got[0]) > 700


def test_matcher_ties_and_limits():
    des2 = np.random.default_rng(0).integers(0, 256, size=(8, 32), dtype=np.uint8)
    des2[1] = des2[0]
    tie = np.stack([des2[0], des2[2]])
    q, t = matching.match_descriptors_device(tie, des2, capacity=64, device="cpu")
    assert (q, t) == ([1], [2])  # row 0 ties for the nearest and fails the ratio test
    assert matching.match_descriptors_device(None, des2, device="cpu") == ([], [])
    assert matching.match_descriptors_device(des2[:1], des2, device="cpu") == ([], [])
    # Above the capacity both sides are padded, as the JAX package's cv2
    # fallback would see them.
    over = np.tile(des2, (9, 1))
    want = jax_matching.match_descriptors_device(over, des2, capacity=64)
    assert matching.match_descriptors_device(over, des2, capacity=64, device="cpu") == want
    if not torch.cuda.is_available():  # no fallback: the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            matching.match_descriptors_device(tie, des2)
