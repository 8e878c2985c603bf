"""The JAX package's seeded random streams, without JAX.

The JAX package seeds its random weights through `jax.random.key(seed)` and
flax's `init`, and its synthetic frames' lighting, texture and voxel draws
through keys made from integers of its numpy stream. This module makes the
same numbers as torch tensors, on any device, so a seed means the same
weights and the same frames in both packages.

What it reproduces, and of which versions:
  * the threefry-2x32 PRNG with `jax_threefry_partitionable` on (the default
    since JAX 0.5; checked against JAX 0.9.0): `key`, `fold_in`, `split`
    (the fold-like split, `_threefry_split_foldlike`) and `bits` (the
    partitionable layout: the flat index as (hi, lo) counters, the two
    output words xor-ed) bit for bit;
  * `uniform` (the mantissa trick, then `max(minval, .)`) bit for bit,
    `permutation` (JAX's sort-based shuffle: stable sorts on 32-bit keys,
    ties kept in order) exactly;
  * `normal` and `truncated_normal` through XLA's float32 `erf_inv`
    polynomial (its multiply-adds fused, as XLA contracts them): 99% of
    values equal to JAX 0.9.0's on the CPU, the rest within 3 ulps (XLA's
    own `log1p` rounds otherwise), and a Dense kernel, times its float32
    standard deviation, within 4 ulps (tests/test_torch_jax_random.py);
  * flax's parameter keys (flax 0.12): `fold_in(key, first 4 bytes of
    sha1(path names + counter))`, big-endian, with
    `flax_fix_rng_separator` off (no separators hashed), and the
    `nn.scan` over the ViT's blocks, which splits the key by block and
    traces its body twice, so a block's parameter counters start after
    the scope's parameter count.

Keys are pairs of Python ints (the two 32-bit words); arrays of random bits
are computed on the device asked for, in int64 lanes masked to 32 bits, and
the float steps of `erf_inv` in float64 rounded to float32 at each step, so
the CPU and the card give the same bits.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cppf2_torch.models.porting import branch_to_tree, load_branch

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2 = np.float32(np.sqrt(2.0))
# XLA's float32 erf_inv (Giles' approximation): coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# stddev of a standard normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = np.float32(0.87962566103423978)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on 32-bit words held in Python ints or
    int64 tensors (keys broadcast against the counters)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int) -> Key:
    """`jax.random.key(seed)` for a 32-bit seed: the words (0, seed)."""
    return (0, int(seed) & _MASK)


def fold_in(k: Key, data: int) -> Key:
    return threefry2x32(k[0], k[1], 0, int(data) & _MASK)


def split(k: Key, num: int = 2) -> List[Key]:
    """`jax.random.split`: key i hashes the counter (0, i)."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def bits(k: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """`jax.random.bits(k, shape)` (uint32) as int64 values in [0, 2^32)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k[0], k[1], idx >> 32, idx & _MASK)
    return (x0 ^ x1).reshape(tuple(shape))


def _unit(k: Key, shape, device) -> torch.Tensor:
    """Uniform float32 in [0, 1): 23 random mantissa bits under exponent 0, minus 1."""
    b = (bits(k, shape, device) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


def uniform(k: Key, shape: Sequence[int], minval=0.0, maxval=1.0, device="cpu") -> torch.Tensor:
    """`jax.random.uniform` in float32: f * (maxval - minval) + minval as one
    fused multiply-add (XLA contracts it), at least minval."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _unit(k, shape, device)
    if lo == 0.0 and hi == 1.0:
        return f
    span = torch.tensor(hi - lo, device=device)
    low = torch.tensor(lo, device=device)
    return torch.maximum(low, _fma32(f, span, low))


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: w = -log1p(-x^2), a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at +-1."""
    w = -torch.log1p(-(x * x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for lo_c, hi_c in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.tensor(np.float32(lo_c), device=x.device),
                        torch.tensor(np.float32(hi_c), device=x.device))
        p = c if p is None else _fma32(p, w, c)
    out = p * x
    return torch.where(torch.abs(x) == 1.0, x * torch.inf, out)


def normal(k: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """`jax.random.normal` in float32: sqrt(2) erf_inv(U(nextafter(-1, 0), 1))."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, lo, 1.0, device)
    return torch.tensor(_SQRT2, device=device) * erf_inv(u)


def truncated_normal(k: Key, lower: float, upper: float, shape: Sequence[int],
                     device="cpu") -> torch.Tensor:
    """`jax.random.truncated_normal` in float32: sqrt(2) erf_inv(U(erf(lower
    / sqrt 2), erf(upper / sqrt 2))), clipped to the open interval."""
    lo32, hi32 = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lo32 / _SQRT2)))
    b = np.float32(math.erf(float(hi32 / _SQRT2)))
    u = uniform(k, shape, a, b, device)
    out = torch.tensor(_SQRT2, device=device) * erf_inv(u)
    return torch.clamp(out, float(np.nextafter(lo32, np.float32(np.inf))),
                       float(np.nextafter(hi32, np.float32(-np.inf))))


def permutation(k: Key, n: int, device="cpu") -> torch.Tensor:
    """`jax.random.permutation(k, n)`: ceil(3 ln n / ln(2^32 - 1)) rounds, each
    a stable sort of the running order by fresh 32-bit keys."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        k, sub = split(k)
        x = x[torch.sort(bits(sub, (n,), device), stable=True).indices]
    return x


# ---------------------------------------------------------------------------
# flax's parameter keys and the JAX package's init trees
# ---------------------------------------------------------------------------

def fold_static(k: Key, data: Sequence) -> Key:
    """flax's `_fold_in_static`: the key folded with the first 4 bytes of the
    sha1 of the path names (utf-8) and counters (big-endian, minimal bytes)."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return fold_in(k, int.from_bytes(m.digest()[:4], byteorder="big"))


def lecun_normal(k: Key, shape: Sequence[int], fan_in: int, device="cpu") -> torch.Tensor:
    """flax's default Dense kernel, `lecun_normal`: truncated_normal(-2, 2) *
    sqrt(1 / fan_in) / 0.87962566, every factor in float32."""
    std = np.float32(np.sqrt(np.float32(1.0 / fan_in))) / _TRUNC_STD
    return truncated_normal(k, -2.0, 2.0, shape, device) * torch.tensor(np.float32(std), device=device)


def _dense_leaves(k: Key, path: tuple, d_in: int, d_out: int, counter: int = 0):
    """A flax Dense's leaf makers: the kernel's key at counter + 1, zero bias."""
    kk = fold_static(k, path + (counter + 1,))
    return {"kernel": lambda dev: lecun_normal(kk, (d_in, d_out), d_in, dev),
            "bias": lambda dev: torch.zeros(d_out, device=dev)}


def _materialize(makers, device):
    if callable(makers):
        return makers(device)
    return {n: _materialize(m, device) for n, m in makers.items()}


def branch_init_tree(module, k: Key, device="cpu") -> Dict:
    """The flax init tree of a ShotBranch / DinoBranch from key `k`, as the
    JAX package's `model.init(k, ...)` makes it: every Dense has its own
    scope, its kernel at counter 1 (lecun_normal), its bias zero. `module`
    (the port's branch) gives the names and shapes."""
    def walk(tree, path):
        if "kernel" in tree:
            d_in, d_out = np.shape(tree["kernel"])
            return _dense_leaves(k, path, d_in, d_out)
        return {n: walk(sub, path + (n,)) for n, sub in tree.items()}

    return {"params": _materialize(walk(branch_to_tree(module)["params"], ()), device)}


def init_branch_(module, seed_key):
    """Load into a ShotBranch / DinoBranch, in place, the init tree the JAX
    package's `model.init(key, ...)` makes from `seed_key` (a seed, or a
    key), drawn where the module's weights lie."""
    k = key(seed_key) if isinstance(seed_key, int) else seed_key
    return load_branch(module, branch_init_tree(module, k, next(module.parameters()).device))


def vit_init_leaves(cfg, k: Key) -> Dict:
    """Leaf makers (device -> tensor) of the JAX package's `DinoViT(cfg)`
    init tree from key `k`, in the tree's layout (blocks stacked on a depth
    axis). Block i draws from split(k, depth)[i] under the "blocks" path;
    its Dense kernels sit at counter (the scope's parameter count) + 1."""
    p, d = cfg.patch_size, cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)
    n_dense = 3 if cfg.quant == "int8" else 2   # kernel, bias (and qscale)
    block_keys = split(k, cfg.depth)
    shapes = {("attn", "qkv"): (d, 3 * d), ("attn", "proj"): (d, d),
              ("mlp_fc1",): (d, hidden), ("mlp_fc2",): (hidden, d)}

    def stacked_kernel(sub, d_in, d_out):
        def make(dev):
            return torch.stack([_dense_leaves(bk, ("blocks",) + sub, d_in, d_out, n_dense)["kernel"](dev)
                                for bk in block_keys])
        return make

    def full(shape, value):
        return lambda dev: torch.full(shape, float(value), device=dev)

    blocks: Dict = {"ls1": full((cfg.depth, d), cfg.layerscale_init),
                    "ls2": full((cfg.depth, d), cfg.layerscale_init),
                    "norm1": {"scale": full((cfg.depth, d), 1.0), "bias": full((cfg.depth, d), 0.0)},
                    "norm2": {"scale": full((cfg.depth, d), 1.0), "bias": full((cfg.depth, d), 0.0)},
                    "attn": {}}
    for sub, (d_in, d_out) in shapes.items():
        leaf = {"kernel": stacked_kernel(sub, d_in, d_out), "bias": full((cfg.depth, d_out), 0.0)}
        if cfg.quant == "int8":
            leaf["qscale"] = full((cfg.depth, d_out), 1.0)
        (blocks["attn"] if sub[0] == "attn" else blocks)[sub[-1]] = leaf
    pos_key = fold_static(k, (2,))
    return {
        "patch_embed": {
            "kernel": lambda dev: lecun_normal(fold_static(k, ("patch_embed", 1)), (p, p, 3, d),
                                               p * p * 3, dev),
            "bias": full((d,), 0.0)},
        "cls_token": full((1, d), 0.0),
        "pos_embed": lambda dev: normal(pos_key, (1 + cfg.pretrain_grid ** 2, d), dev)
        * torch.tensor(np.float32(0.02), device=dev),
        "blocks": blocks,
        "norm": {"scale": full((d,), 1.0), "bias": full((d,), 0.0)},
    }


def vit_init_tree(cfg, k: Key, device="cpu") -> Dict:
    """The JAX package's `DinoViT(cfg).init(k, image)` tree on `device` (no
    parameter depends on the image size)."""
    return {"params": _materialize(vit_init_leaves(cfg, k), device)}
