"""k-means++ Gumbel noise on the card (kernel `csrc/gumbel.cu`).

The k-means++ draws of `ops/cluster.py kmeans_rows` take row i of a
(n_draws, m) float32 Gumbel table, drawn under the i-th sub-key of `key, sub
= split(key)` repeated from `PRNGKey(seed)`, as the JAX package's `kmeans`
draws them.  The bit contract is JAX's partitionable threefry
(`ops/prng.py`): element j of row i is `gumbel` of the bits
`threefry2x32(sub_i, hi32(j), lo32(j))`, so it depends on the sub-key and on
j alone, and the table of (seed, m, n) is the prefix [:n, :m] of the table of
any larger (seed, M, N).  No table is cached: one chain of sub-keys per seed
and device (`subkeys`) serves every table, and each table is drawn afresh.

The kernel's arithmetic is `prng.gumbel`'s: fused multiply-adds exactly where
`prng.log32` calls `fma32`, every other operation rounded on its own (its
intrinsics are never contracted, and the build's `-fmad=false` keeps any
plain expression unfused).  The plain version is the host table itself,
`ops/cluster.py _gumbel_table`, which draws its rows from the same chain.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from roibasedimagecompression_torch.ops import prng
from roibasedimagecompression_torch.ops.cuda import _build
from roibasedimagecompression_torch.utils import flops as FLOPS

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
launch_shapes: collections.Counter = collections.Counter()  # (seed, n_draws, m) of every table drawn
_count_lock = threading.Lock()  # encode_stream launches from several threads

# Sub-keys of the codec's widest k-means++ call (every caller seeds k-means++
# only at k_max <= 256): one chain of this length a seed and device serves
# them all.  A longer request gets a chain of its own, not kept.
_CHAIN = 256
_chains: dict = {}  # (seed, device) -> (_CHAIN, 2) int32 sub-key bits on the device
_chain_lock = threading.Lock()


def _device(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _chain_tensor(seed: int, n: int, dev: torch.device) -> torch.Tensor:
    host = prng.subkey_chain(seed, n)
    return torch.from_numpy(host.view(np.int32)).to(dev)


def subkeys(seed: int, n: int, device) -> torch.Tensor:
    """(N, 2) int32 tensor on `device`, N >= n: the bits of the first N
    sub-keys of `seed`'s split chain (`prng.subkey_chain`).  Up to n = 256
    one chain a seed and device, computed on the host once; a longer one is
    computed for the call and allocated on the current stream, which the
    launch that reads it uses too."""
    dev = _device(torch.device(device))
    if n > _CHAIN:
        return _chain_tensor(int(seed), n, dev)
    key = (int(seed), dev)
    with _chain_lock:
        chain = _chains.get(key)
        if chain is None:
            chain = _chains[key] = _chain_tensor(int(seed), _CHAIN, dev)
        return chain


def gumbel_rows(keys: torch.Tensor, m: int) -> torch.Tensor:
    """(n, m) float32 Gumbel noise, row i drawn under sub-key keys[i]: keys
    (n, 2) int32 sub-key bits on a CUDA device, n <= 65535.  One kernel
    launch on the current stream."""
    global launches
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (n, 2) int32, got {tuple(keys.shape)} {keys.dtype}")
    if not 1 <= keys.shape[0] <= 65535 or not 1 <= m < 2**31:
        raise ValueError(f"need 1 <= n <= 65535 and 1 <= m < 2^31, got {keys.shape[0]}, {m}")
    if keys.device.type != "cuda" or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous CUDA tensor, got {keys.device}")
    lib = _build.load("gumbel")
    n = keys.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=keys.device)
    _build.launch(lib, "gumbel_launch", keys.device, keys.data_ptr(), out.data_ptr(), n, m)
    with _count_lock:
        launches += 1
    # 61 float operations an element (a fused multiply-add counts two), 4
    # bytes written; threefry's integer work is not counted.
    FLOPS.add(61 * n * m, 4 * n * m + 8 * n)
    return out


def gumbel_table(seed: int, m: int, n_draws: int, device) -> torch.Tensor:
    """(n_draws, m) float32: the k-means++ noise of `seed` on `device`, equal
    bit for bit to `ops/cluster.py _gumbel_table(seed, m, n_draws)`."""
    out = gumbel_rows(subkeys(seed, n_draws, device)[:n_draws], m)
    with _count_lock:
        launch_shapes[(int(seed), n_draws, m)] += 1
    return out
