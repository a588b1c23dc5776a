"""ORB descriptor matching on the card (port of ``ops/matching.py``).

Hamming distances of 256-bit descriptors as one product of their bits:

    hamming(a, b) = |a| + |b| - 2 <bits(a), bits(b)>

so the [C, C] distance matrix is one [C, 256] x [256, C] product (0/1
values, exact in fp32 and in TF32) and the two nearest neighbours Lowe's
ratio test needs are a ``torch.topk(k=2, largest=False)`` over the columns,
the padded ones set to 1e9. Shapes are padded to a fixed capacity. The
bits are unpacked on the host, and the ratio, threshold and one-to-one
pass stays on the host, as in the JAX package, which computes the product
in XLA, outside any Pallas kernel.

Ties: distances are integers, so they are common. A tie for the nearest
place fails the ratio test (``best < ratio * second`` with best equal to
second), whichever index comes first; a tie for the second place changes
only an index that nothing reads. So the lists do not depend on
``topk``'s tie order.

Inputs over the capacity are padded to the next multiple of 128 at or
above the larger side instead (the JAX package hands them to cv2's
``BFMatcher``, which the port does not have): the bit product is exact at
any size, so the lists are the same.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device

CAPACITY = 3072  # >= ORB's nfeatures=3000
_BIG = 1e9


def _unpack_bits(des: np.ndarray, capacity: int) -> np.ndarray:
    """[N, 32] uint8 -> [capacity, 256] float32 bit matrix (zero padded)."""
    n = des.shape[0]
    bits = np.unpackbits(des, axis=1).astype(np.float32)  # [N, 256]
    out = np.zeros((capacity, bits.shape[1]), np.float32)
    out[:n] = bits
    return out


def _knn2_device(
    bits1: torch.Tensor, bits2: torch.Tensor, n2: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two smallest Hamming distances of every row of ``bits1``
    against the first ``n2`` rows of ``bits2`` (both [C, 256] 0/1 fp32):
    (dists [C, 2] fp32, idxs [C, 2] int64), ascending."""
    s1 = bits1.sum(dim=1, keepdim=True)  # [C, 1]
    s2 = bits2.sum(dim=1)[None, :]  # [1, C]
    dist = s1 + s2 - 2.0 * (bits1 @ bits2.T)
    col = torch.arange(dist.shape[1], device=dist.device)[None, :]
    dist = torch.where(col < n2, dist, _BIG)
    return torch.topk(dist, 2, dim=1, largest=False)


def match_descriptors_device(
    des1: Optional[np.ndarray],
    des2: Optional[np.ndarray],
    ratio: float = 0.75,
    max_distance: float = 32.0,
    capacity: int = CAPACITY,
    device=None,
) -> Tuple[List[int], List[int]]:
    """Lowe's ratio test (``ratio``), a Hamming threshold (``max_distance``)
    and one match per descriptor on either side, in query order, as the
    reference's ``slam/frontend.py:match_descriptors``: the query and
    train indices of the matches. ``device`` defaults to CUDA."""
    if des1 is None or des2 is None or len(des1) < 2 or len(des2) < 2:
        return [], []
    n1, n2 = len(des1), len(des2)
    if n1 > capacity or n2 > capacity:
        capacity = -(-max(n1, n2) // 128) * 128
    device = resolve_device(device)
    bits1 = torch.from_numpy(_unpack_bits(np.asarray(des1, np.uint8), capacity))
    bits2 = torch.from_numpy(_unpack_bits(np.asarray(des2, np.uint8), capacity))
    dists, idxs = _knn2_device(bits1.to(device), bits2.to(device), n2)
    dists, idxs = dists.cpu().numpy(), idxs.cpu().numpy()
    return _greedy(dists, idxs, n1, ratio, max_distance)


def _greedy(
    dists: np.ndarray, idxs: np.ndarray, n1: int, ratio: float, max_distance: float
) -> Tuple[List[int], List[int]]:
    """The host's pass over the first ``n1`` rows of the 2-NN: keep a query
    whose nearest passes the ratio test and the threshold, unless its
    train index is already taken."""
    out1: List[int] = []
    out2: List[int] = []
    taken = set()
    for q in range(n1):
        best, second = dists[q]
        train = int(idxs[q, 0])
        if best < ratio * second and best < max_distance and train not in taken:
            out1.append(q)
            out2.append(train)
            taken.add(train)
    return out1, out2
