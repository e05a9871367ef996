"""Hard Gumbel sampling: the CUDA kernel ``csrc/gumbel.cu`` and its wrapper.

Counterpart of ``act_tpu/ops/sampling.py``. The noise is the counter hash of
the JAX kernel's interpret path, so the ids equal ``gumbel_argmax_pallas``
in interpret mode for the same seed words. The kernel screens every lane
against bounds of its noise from a table over buckets of its hash and takes
the exact noise only for the lanes that can still win; ``launch_geometry``
picks the buckets and the persistent grid. See the note at the top of the
source. Below the wrapper: a plain model of the screen and rows of hard cases
(ties, near ties, NaN, +-inf, u = 1 lanes), for the tests, the sweep and
``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from act_tpu_torch.ops import _backend, work
from act_tpu_torch.ops.fps import _sms
from act_tpu_torch.ops.reference import _MASK32, gumbel_argmax_ref, gumbel_chunk
from act_tpu_torch.parallel.mesh import data_index

DTYPES = (torch.bfloat16, torch.float32)
MIN_BITS, MAX_BITS = 6, 10  # bucket bits k the kernel takes
BUCKET_BITS = 8  # launch_geometry's k
CUT = 8  # the candidates are the top 2^-8 of the hash's 31 bits
WARPS = 8  # a block of the kernel: 256 threads, a warp a row
BLOCKS_PER_SM = 4  # resident together: __launch_bounds__(256, 4)
SHARED_LIMIT = 48 * 1024  # a block's default shared memory: no opt-in attribute
B0 = 2 ** 31 - 2 ** (31 - CUT)  # the candidates' first hash bits


def table_bytes(k: int) -> int:
    """Shared memory of the bucket table: 2^(k+1) + 1 float2."""
    return 8 * ((2 << k) + 1)


def launch_geometry(rows: int, v: int, sms: int) -> Tuple[int, int]:
    """(bucket bits k, blocks) of a Gumbel-argmax launch on a card of ``sms``
    SMs.

    The table splits the candidates (the lanes whose hash lies in the top
    2^-8, about 32 a row at V = 8192) and all bits into 2^k buckets each;
    k = 8, where the sweep found the path shape faster than at 6 and 10. A
    warp takes a row; the grid is persistent: the blocks that stay resident
    together, or as many as the rows need, each taking 8 rows at a time.
    Rows that the kernel does not screen (V not a multiple of a 16-byte
    load's lanes, V below a tile of 1024 bf16 or 512 f32 lanes, or an
    unaligned row) take a block a row whatever the geometry.
    ``python -m act_tpu_torch.kernel_sweep`` times the alternatives."""
    return BUCKET_BITS, max(1, min(sms * BLOCKS_PER_SM, -(-rows // WARPS)))


def bound_violations(k: int, device) -> Tuple[int, int]:
    """Over all 2^31 hash bits on the card: (bits whose noise is below its
    predecessor's or NaN, bits whose noise lies outside either of its
    buckets' [Glo, Ghi] in the table of k). Both 0 make the kernel's screen
    exact. Not a path kernel: not counted in ``_backend.LAUNCHES``."""
    if not MIN_BITS <= k <= MAX_BITS:
        raise ValueError(f"k must be in [{MIN_BITS}, {MAX_BITS}], got {k}")
    bad = torch.zeros(2, dtype=torch.int64, device=device)
    fn = _backend.library("gumbel_argmax").act_gumbel_bound_check
    fn.argtypes, fn.restype = [ctypes.c_int] + [ctypes.c_void_p] * 2, ctypes.c_int
    err = fn(k, bad.data_ptr(), torch.cuda.current_stream(bad.device).cuda_stream)
    if err:
        raise RuntimeError(f"gumbel bound check launch failed: cudaError {err}")
    return tuple(int(n) for n in bad.tolist())


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """Two int32 seed words from ``generator``, on its device (no host sync)."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=generator, device=generator.device)


def fold_seed(seed: torch.Tensor, index: int) -> torch.Tensor:
    """``seed`` with ``index * -1640531527`` (int32) XORed into word 0, as
    each shard of the JAX kernel on a mesh folds its ``data`` axis index
    (``act_tpu/ops/sampling.py:127-130``); index 0 leaves it as it is."""
    w = (int(index) * -1640531527) & 0xFFFFFFFF
    w = w - (1 << 32) if w >= 1 << 31 else w
    return seed ^ torch.tensor([w, 0], dtype=torch.int32, device=seed.device)


def gumbel_argmax(logits: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """ids = argmax(logits + Gumbel noise) over the last axis.

    logits (..., V) bf16 or f32, seed (2,) int32 on the same device -> (...)
    int32, the first index of the maximum. Forward-value equal to a hard
    ``gumbel_softmax`` at tau 1; no gradient flows. Data index r of a
    data-parallel run draws its rows' noise from ``fold_seed(seed, r)``: the
    one draw of a step that is per rank by design, as the JAX kernel's is
    per shard of the mesh's 'data' axis (``axis_index('data')``); model
    peers hold the same rows and draw alike."""
    if logits.dim() < 1 or logits.shape[-1] < 1:
        raise ValueError(f"logits must be (..., V) with V >= 1, got {tuple(logits.shape)}")
    if seed.shape != (2,) or seed.dtype != torch.int32:
        raise ValueError(f"seed must be a (2,) int32 tensor, got {seed.dtype} {tuple(seed.shape)}")
    if seed.device != logits.device:
        raise ValueError(f"seed on {seed.device}, logits on {logits.device}")
    if data_index():
        seed = fold_seed(seed, data_index())
    work.record("gumbel_argmax", logits.numel() // logits.shape[-1], logits.shape[-1])
    if logits.device.type == "cpu":
        return gumbel_argmax_ref(logits, seed)
    if logits.dtype not in DTYPES:
        raise ValueError(f"gumbel_argmax logits: the CUDA kernel takes bf16 or float32, "
                         f"got {logits.dtype}")
    _backend.check_cuda_input(logits, "gumbel_argmax logits", logits.dtype)
    _backend.check_cuda_input(seed, "gumbel_argmax seed", torch.int32)
    *lead, v = logits.shape
    rows = logits.numel() // v
    out = torch.empty(*lead, dtype=torch.int32, device=logits.device)
    if rows:
        geo = launch_geometry(rows, v, _sms(logits.device.index))
        _backend.launch("gumbel_argmax", logits, seed, out, rows, v, gumbel_chunk(rows, v),
                        int(logits.dtype == torch.bfloat16), *geo)
    return out


# -- a plain model of the kernel's screen, and hard rows to check it on -------

def hash_bits(rows: int, v: int, seed: torch.Tensor, device) -> torch.Tensor:
    """The 31 hash bits of every lane of a (rows, V) call, as
    ``gumbel_perturbed_ref`` draws them: (rows, V) int64."""
    s0, s1 = (int(s) for s in seed.reshape(-1)[:2].tolist())
    chunk = gumbel_chunk(rows, v)
    row = torch.arange(rows, dtype=torch.int64, device=device)
    base = ((row % chunk) * 0x9E3779B9 + s0 * 69069 + s1 * 1013904223
            + (row // chunk) * 22695477 + 374761393)
    h = (base[:, None] + torch.arange(v, dtype=torch.int64, device=device) * 40503) & _MASK32
    h = h ^ ((h << 13) & _MASK32)
    h = h ^ (h >> 17)
    h = h ^ ((h << 5) & _MASK32)
    return h >> 1


def noise_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """The Gumbel noise of int64 hash bits, -log(-log(max(f32(bits) 2^-31, 1e-10)))."""
    return -torch.log(-torch.log(torch.clamp_min(bits.to(torch.float32) * 2.0 ** -31, 1e-10)))


def buckets(bits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two table entries of int64 hash bits: (entry 0 below the
    cut B0, else 1 + which of 2^k equal parts of [B0, 2^31) holds them;
    2^k + 1 + which of 2^k equal parts of [0, 2^31) holds them)."""
    top = torch.where(bits < B0, 0, 1 + ((bits - B0) >> (31 - CUT - k)))
    return top, (1 << k) + 1 + (bits >> (31 - k))


def bucket_table(k: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(Glo, Ghi), each (2^(k+1) + 1,) f32: the noise at the first and last
    bits of each table entry's bucket (see :func:`buckets`)."""
    b = torch.arange(1 << k, dtype=torch.int64, device=device)
    top, uni = 31 - CUT - k, 31 - k
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    first = torch.cat([zero, B0 + (b << top), b << uni])
    end = torch.cat([zero + B0, B0 + ((b + 1) << top), (b + 1) << uni])
    return noise_of_bits(first), noise_of_bits(end - 1)


def screen_ref(x: torch.Tensor, bits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's rule in plain torch: x (rows, V) logits, bits (rows, V)
    hash bits -> (ids (rows,) int32, survivors a row (rows,) int64).

    A candidate (bits >= B0) is bounded by its bucket among the top 2^k, the
    others below by Glo[0] and above by their bucket among the uniform 2^k:
    lo, hi = f32(x) + those bounds. T is the row's max of lo ignoring NaN; a
    lane survives unless hi < T, and the first index of the largest exact
    value among the survivors wins (NaN above every number). (The kernel
    takes T over a warp's tiles so far and looks up a lane below the cut only
    where f32(x) + Ghi[0] reaches T: the same ids, a few more survivors.)"""
    glo, ghi = bucket_table(k, x.device)
    xf = x.float()
    top, uni = buckets(bits, k)
    lo = xf + glo[top]
    hi = xf + torch.where(top > 0, ghi[top], ghi[uni])
    t = torch.where(torch.isnan(lo), float("-inf"), lo).amax(-1, keepdim=True)
    live = ~(hi < t)
    val = torch.where(live, xf + noise_of_bits(bits), float("-inf"))
    return torch.argmax(val, dim=-1).to(torch.int32), live.sum(-1)


def exact_logit(target: float, g: float):
    """An f32 logit x with fl(x + g) == target, g an f32 noise value, or None
    where rounding to even steps over the target."""
    t = torch.tensor(target, dtype=torch.float32)
    gt = torch.tensor(g, dtype=torch.float32)
    x = t - gt
    for _ in range(8):
        s = x + gt
        if s == t:
            return float(x)
        x = torch.nextafter(x, torch.tensor(float("inf") if s < t else float("-inf")))
    return None


def gumbel_cases(rows: int, v: int, dtype: torch.dtype, device):
    """(logits, seed, cases): (rows, V) randn logits of ``dtype`` (generator
    seed 0) with hard rows written in, the seed words, and {case: (row, the
    id it must give)}, each case on a row of its own.

    Exact ties (the same value at two lanes, the first index wins) and near
    ties (one step apart, in either order) of two lanes placed in one
    thread's loads of a tile, one warp's tile and two tiles of a row (the
    screened kernel's layout: a tile is 32 threads x 4 loads; on the scalar
    path they are merely spread lanes): in f32 the logits solved for
    the values 30 and one ulp above, in bf16 logits 2^100 and one bf16 step
    above, which absorb the noise. The same for pairs of lanes whose noise is
    equal (their logits 30, or one step above), sorted by where they lie. An
    all-zero row; a NaN, a +inf logit; and where the seed draws u = 1 lanes
    (+inf noise; the seed is the first [s, 1], s < 16, that has two such
    rows when rows x V >= 2^25), a -inf logit on one (a NaN value, which
    wins) and one that wins tied at +inf with a later +inf logit. Cases whose
    lanes the noise does not give are left out."""
    seed = torch.tensor([0, 1], dtype=torch.int32, device=device)
    bits = hash_bits(rows, v, seed, device)
    for s in range(16 if rows * v >= 2 ** 25 else 0):
        seed = torch.tensor([s, 1], dtype=torch.int32, device=device)
        bits = hash_bits(rows, v, seed, device)
        if int(torch.isposinf(noise_of_bits(bits)).any(-1).sum()) >= 2:
            break
    g = noise_of_bits(bits)
    del bits
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(rows, v, generator=gen, device=device)
    inf_rows = torch.isposinf(g).any(-1).nonzero().flatten().tolist()
    cases = {}
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    vec = vec if v % vec == 0 else 1  # lanes a load: the vector or the scalar path
    loads = 4  # a thread's loads a tile

    def lane(tile, load, thread, q):
        return ((tile * loads + load) * 32 + thread) * vec + q

    def where(i, j):
        (ti, ci), (tj, cj) = (divmod(n // vec, 32 * loads) for n in (i, j))
        return ("two tiles" if ti != tj else "one thread" if ci % 32 == cj % 32 else "one warp")

    def place(name, row, want, **lanes):
        cases[name] = (row, want)
        for lane, val in lanes.values():
            x[row, lane] = val
        if row in free:
            free.remove(row)

    # pairs of lanes with equal finite noise below 2, by where they lie
    srt, idx = g.sort(-1)
    eq = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < 2)
    pairs, taken = {}, set(inf_rows)  # where -> up to 3 (row, i, j) on rows of their own
    at = eq.nonzero()
    ends = torch.stack([idx[at[:, 0], at[:, 1]], idx[at[:, 0], at[:, 1] + 1]], 1)
    for r, (i, j) in zip(at[:, 0].tolist(), ends.sort(1).values.tolist()):
        at_ = where(i, j)
        if r not in taken and len(pairs.setdefault(at_, [])) < 3:
            pairs[at_].append((r, i, j))
            taken.add(r)
    free = [r for r in range(rows) if r not in taken]
    up = 30.125 if dtype == torch.bfloat16 else float(
        torch.nextafter(torch.tensor(30.0), torch.tensor(64.0)))
    kinds = (("tie", 30.0, 30.0, 0), ("near tie, later lane larger", 30.0, up, 1),
             ("near tie, earlier lane larger", up, 30.0, 0))  # name, logits, winner
    for at_, found in pairs.items():
        for (r, i, j), (name, a, b, w) in zip(found, kinds):
            place(f"{name}, equal noise, {at_}", r, (i, j)[w], a=(i, a), b=(j, b))
    # lanes placed by hand: f32 logits solved for the value 30 (or one ulp
    # above); bf16 logits 2^100 (or one bf16 step above), which absorb the noise
    big = (2.0 ** 100, 2.0 ** 100 * (1 + 2 ** -7))
    first = lane(0, 0, 0, min(1, vec - 1))
    placed = {"one thread": (first, lane(0, 1, 0, vec - 1)), "one warp": (first, lane(0, 2, 5, 0)),
              "two tiles": (first, lane(1, 0, 3, 0))}
    for at_, (i, j) in placed.items():
        for name, a, b, w in kinds:
            if j >= v or len(free) < 4:
                break
            if dtype == torch.float32:
                for r in free:
                    la, lb = exact_logit(a, float(g[r, i])), exact_logit(b, float(g[r, j]))
                    if la is not None and lb is not None:
                        break
                a, b = la, lb
            else:
                r, a, b = free[0], big[a != 30.0], big[b != 30.0]
            place(f"{name}, {at_}", r, (i, j)[w], a=(i, a), b=(j, b))
    if len(free) >= 3:
        x[free[0]] = 0.0
        place("all-zero row", free[0], int(torch.argmax(g[free[0]])))
        place("NaN logit", free[0], min(5, v - 1), a=(min(5, v - 1), float("nan")))
        place("+inf logit", free[0], v - 1, a=(v - 1, float("inf")))
    if len(inf_rows) >= 2:
        (ra, ja), (rb, jb) = [(r, int(torch.isposinf(g[r]).nonzero()[0])) for r in inf_rows[:2]]
        cases["-inf logit on a u = 1 lane"] = (ra, ja)
        x[ra, ja] = float("-inf")
        cases["u = 1 lane wins, tied at +inf"] = (rb, jb)
        if jb < v - 1:
            x[rb, v - 1] = float("inf")
    return x.to(dtype), seed, cases


def check_gumbel_cases(ids: torch.Tensor, want: torch.Tensor, cases: dict) -> list:
    """The cases whose kernel id differs from the plain version's or from the
    id the case must give."""
    return [name for name, (r, i) in cases.items()
            if not int(ids[r]) == int(want[r]) == i]
