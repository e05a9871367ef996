// Chamfer nearest neighbours and their backward on Hopper (sm_90a).
//
// Replaces:
// - chamfer_nn: act_tpu/ops/chamfer.py::_nn_pair_kernel (its pallas_call at
//   chamfer.py:134): both directed nearest-neighbour squared distances and
//   their argmin indices, the forward under grad;
// - chamfer_nn_min: act_tpu/ops/chamfer.py::_nn_pair_min_kernel (chamfer.py:235):
//   the same distances without indices, the primal that runs when nothing
//   takes a gradient (the reconstruction metrics);
// - chamfer_bwd: act_tpu/ops/chamfer.py::_chamfer_bwd (chamfer.py:341-369),
//   which on a TPU runs the Pallas gather kernel (ops/gather.py, through
//   ops/reference.py::gather_coords) and an XLA scatter-add.
//
// Arithmetic: d = (dx*dx + dy*dy) + dz*dz with dx = qx - tx, each operation
// rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: nvcc would otherwise
// contract a multiply and an add into an FMA), in the order of
// chamfer.py:70-72. The distances therefore equal the plain versions
// (ops/reference.py::chamfer_ref, chamfer_min_ref) bit for bit, and the
// indices are exact, ties included: the first index of the minimum wins in
// both directions, as chamfer.py:75-79 and torch.argmin choose. Coordinates
// must be finite; distances that overflow to inf are ordered like any other.
//
// Bound: the function needs each squared distance once, 8 f32 operations (3
// subtractions, 3 products, 2 sums), and one compare a direction: 10 a pair.
// The recon loss of a Stage-I step at B=64 (two calls, (4096, 8)x(4096, 32)
// and (4096, 32)x(4096, 32)) is 5.2 M pairs, 52 MFLOP (0.8 us at 67 TFLOP/s)
// against 8.5 MB of inputs and outputs (2.5 us at 3.35 TB/s): bytes bound it,
// and both are below the cost of a launch. The whole-cloud shape
// (32, 2048)^2 is operations-bound (1.3 GFLOP, 20 us). The backward moves
// bytes only (x, y, i1, i2, g1, g2 read once, dx, dy written once).
//
// Design of the forward. As the TPU kernel does, each distance is computed
// once and gives both the row minimum (x -> y) and the column minimum
// (y -> x). A block owns tiles of the (N x M) distance matrix of its clouds:
// tq points of x by tt points of y (ops/chamfer.py launch_geometry picks tq,
// tt, the points of x a lane R, the threads and the tiles a block). The tile's
// points of y are staged in shared memory as float4. Its w lanes form a
// wq x wt grid: wq = tq / R lanes across its points of x, each holding R
// consecutive points in registers, and wt lanes across its points of y,
// which walk the staged points wt at a time; each shared-memory load serves
// R distances and a lane runs R independent chains. A column (a point of y)
// is finished by a butterfly of shuffles over the wq lanes that share it,
// and, for the indices, a ballot finds the first lane and the first of its
// R points at the minimum (the smallest index of x). A row is reduced in
// registers along the walk, then once at its end over the wt lanes by
// shuffles of its key, then in shared memory over the wpc warps that split
// the tile's points of y. Large clouds take one tile a block; small clouds
// (the recon loss's 4096 groups, at most 32 points of x) fit one tile each,
// 32 / w of them a warp. With R up to 8, a column's shuffles serve up to 8
// distances a lane. A tile's threads stage its points and
// store its minima, so a thread finds its tile once: index arithmetic done
// per element cost as much as the distances at the recon loss's sizes.
// Tiles of one cloud merge without order: for a finite non-negative f32 (a
// sum of squares, never -0) or +inf, the bit pattern read as uint32 sorts
// like the value, so chamfer_nn_min merges distances with atomicMin on
// unsigned into d1 and d2, which the launch function first sets to all ones
// (cudaMemsetAsync on the same stream). chamfer_nn merges the keys
// (bits << 32) | index with atomicMin on unsigned long long, whose minimum
// is the smallest distance with the first index among equals, into a
// scratch buffer that the wrapper allocates; a second kernel unpacks the
// keys into (d, i). A minimum does not depend on the order of the atomics,
// so the results are deterministic. A direction whose minima a single tile
// completes (every column when N <= tq, every row when M <= tt) is written
// directly, without memset, atomics or unpacking.
//
// Design of the backward. One thread per point of x and of y (B*N + B*M
// threads) reads its saved partner index, gathers the partner, computes
// v = (2 (q - partner)) g in the JAX function's order, adds v to its own
// gradient row and -v to its partner's row with atomicAdd on f32. The launch
// function zeroes dx and dy first (cudaMemsetAsync on the same stream). The
// atomic sums run in an order that changes from run to run, so the gradients
// equal the plain version (ops/reference.py::chamfer_bwd_ref) to rounding,
// not bit for bit. An index outside the partner cloud makes the point's own
// gradient NaN.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxShared = 48 * 1024;  // the default limit: no opt-in attribute

// the merge key of a minimum: distance bits, and below them its index
template <bool kIndex>
using Key = std::conditional_t<kIndex, unsigned long long, unsigned>;

template <bool kIndex>
__device__ __forceinline__ Key<kIndex> make_key(float d, int index) {
  if constexpr (kIndex)
    return (static_cast<unsigned long long>(__float_as_uint(d)) << 32)
           | static_cast<unsigned>(index);
  else
    return __float_as_uint(d);
}

// One forward launch: the clouds, the outputs and the tiling.
struct Fwd {
  const float* x;  // (b, n, 3), held in registers
  const float* y;  // (b, m, 3), staged in shared memory
  float* d1;
  int* i1;
  float* d2;
  int* i2;
  void* k1;  // the row minima's atomicMin target (b, n), or null: written directly
  void* k2;  // the column minima's (b, m), or null
  int b, n, m;
  int tq, tt;  // points of x and of y in a tile
  int w;       // lanes on one tile: wq x wt; 32 / w tiles a warp
  int wq;      // lanes across the tile's points of x (tq / R)
  int wt;      // lanes across its points of y
  int wpc;     // warps that split a tile's points of y
  int pack;    // tiles a block
  int qtiles, ttiles;
};

struct Tile {
  int cloud, q0, t0;
  bool on;
};

// tile `slot` of this block: its cloud and first points of x and y; an
// inactive slot (past the last tile) reads cloud 0 and stores nothing
__device__ __forceinline__ Tile tile_of(const Fwd& f, int slot) {
  const int u = blockIdx.x * f.pack + slot;  // the launcher keeps tiles below 2^31
  const int per = f.qtiles * f.ttiles;
  if (u >= f.b * per) return Tile{0, 0, 0, false};
  const int cloud = u / per, r = u - cloud * per, qt = r / f.ttiles;
  return Tile{cloud, qt * f.tq, (r - qt * f.ttiles) * f.tt, true};
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float4 p) {
  const float dx = __fsub_rn(qx, p.x), dy = __fsub_rn(qy, p.y), dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// a finished minimum: merged into `merged` by atomicMin, or written directly
template <bool kIndex>
__device__ __forceinline__ void put(Key<kIndex> key, long long o, float* d, int* i,
                                    void* merged) {
  if (merged) {
    atomicMin(static_cast<Key<kIndex>*>(merged) + o, key);
  } else if constexpr (kIndex) {
    d[o] = __uint_as_float(static_cast<unsigned>(key >> 32));
    i[o] = static_cast<int>(static_cast<unsigned>(key));
  } else {
    d[o] = __uint_as_float(key);
  }
}

template <bool kIndex, int R>
__global__ void __launch_bounds__(kMaxThreads) nn_kernel(Fwd f) {
  using K = Key<kIndex>;
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = lane / f.w, sl = lane - seg * f.w;  // the warp's tile, lane in it
  const int ql = sl & (f.wq - 1), tl = sl / f.wq;     // lane across x, across y
  const int group = warp / f.wpc, part = warp - group * f.wpc;
  const int slot = group * (32 / f.w) + seg;
  // this thread's rank among the wpc * w threads of its tile, which stage
  // the tile's points of y and store its minima between them
  const int rank = part * f.w + sl, stride = f.wpc * f.w;
  // the wq lanes that share this lane's columns
  const unsigned colmask =
      f.wq == 32 ? kFull : ((1u << f.wq) - 1u) << (seg * f.w + tl * f.wq);
  const Tile t = tile_of(f, slot);
  // shared memory: pack x tt points of y, pack x tt column minima, and
  // pack x wpc x tq row minima, one set a warp
  float4* tgt = smem + slot * f.tt;
  K* colres = reinterpret_cast<K*>(smem + f.pack * f.tt);
  K* cres = colres + slot * f.tt;
  K* rowpart = colres + f.pack * f.tt + slot * f.wpc * f.tq;
  const int tcount = min(f.tt, f.m - t.t0);  // points of y in the tile
  const float* ys = f.y + (static_cast<long long>(t.cloud) * f.m + t.t0) * 3;
  for (int j = rank; j < tcount; j += stride)
    tgt[j] = make_float4(ys[3 * j], ys[3 * j + 1], ys[3 * j + 2], 0.f);
  // this warp's share of the tile's points of y, walked wt at a time; the
  // same for every lane, since tiles share a warp only when each holds a
  // whole cloud. A lane past the share's end takes its last point again:
  // the same distances and keys, stored once.
  const int chunk = (f.tt + f.wpc - 1) / f.wpc, lo = part * chunk;
  const int cnt = max(0, min(chunk, tcount - lo)), steps = (cnt + f.wt - 1) / f.wt;
  float qx[R], qy[R], qz[R], best[R];
  int bi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    // a lane past the cloud's last point of x holds a copy of it: equal
    // distances, a larger index, never stored
    const int q = min(t.q0 + ql * R + k, f.n - 1);
    const float* p = f.x + (static_cast<long long>(t.cloud) * f.n + q) * 3;
    qx[k] = p[0];
    qy[k] = p[1];
    qz[k] = p[2];
    best[k] = INFINITY;
    bi[k] = min(tl, cnt - 1);  // the lane's first point of y
  }
  __syncthreads();
#pragma unroll 4
  for (int it = 0; it < steps; ++it) {
    const int j = min(it * f.wt + tl, cnt - 1);
    const float4 p = tgt[lo + j];
    float d[R];
    float c = INFINITY;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      d[k] = sq_dist(qx[k], qy[k], qz[k], p);
      c = fminf(c, d[k]);
      if constexpr (kIndex) {
        // strictly smaller: the first index of the lane's minimum (an
        // all-inf lane keeps its first point)
        if (d[k] < best[k]) {
          best[k] = d[k];
          bi[k] = j;
        }
      } else {
        best[k] = fminf(best[k], d[k]);
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      if (off < f.wq) c = fminf(c, __shfl_xor_sync(kFull, c, off));
    K key;
    if constexpr (kIndex) {
      int first = R;  // the lane's first point of x at the column minimum
#pragma unroll
      for (int k = R - 1; k >= 0; --k)
        if (d[k] == c) first = k;
      const int src = __ffs(__ballot_sync(kFull, first < R) & colmask) - 1;
      const int at = __shfl_sync(kFull, first, src);
      key = make_key<true>(c, t.q0 + (src - seg * f.w - tl * f.wq) * R + at);
    } else {
      key = make_key<false>(c, 0);
    }
    if (ql == (it & (f.wq - 1)) && it * f.wt + tl < cnt) cres[lo + j] = key;
  }
  // the row minima of the wt lanes across y meet by shuffles
#pragma unroll
  for (int k = 0; k < R; ++k) {
    K key = cnt > 0 ? make_key<kIndex>(best[k], t.t0 + lo + bi[k]) : ~K(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off < f.wq || off >= f.w) continue;
      const K v = __shfl_xor_sync(kFull, key, off);
      key = v < key ? v : key;
    }
    if (tl == 0) rowpart[part * f.tq + ql * R + k] = key;
  }
  __syncthreads();
  if (!t.on) return;
  const int qcount = min(f.tq, f.n - t.q0);
  for (int qi = rank; qi < qcount; qi += stride) {
    K key = rowpart[qi];
    for (int h = 1; h < f.wpc; ++h) {
      const K v = rowpart[h * f.tq + qi];
      key = v < key ? v : key;  // the earlier share wins a tie
    }
    put<kIndex>(key, static_cast<long long>(t.cloud) * f.n + t.q0 + qi, f.d1, f.i1, f.k1);
  }
  for (int j = rank; j < tcount; j += stride)
    put<kIndex>(cres[j], static_cast<long long>(t.cloud) * f.m + t.t0 + j, f.d2, f.i2, f.k2);
}

// the merged keys of chamfer_nn -> (d, i): n1 rows from k1, then n2 columns from k2
__global__ void unpack_kernel(const unsigned long long* k1, float* d1, int* i1, long long n1,
                              const unsigned long long* k2, float* d2, int* i2, long long n2) {
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n1 + n2) return;
  const unsigned long long* k = k1;
  float* d = d1;
  int* i = i1;
  if (e >= n1) {
    e -= n1;
    k = k2;
    d = d2;
    i = i2;
  }
  const unsigned long long key = k[e];
  d[e] = __uint_as_float(static_cast<unsigned>(key >> 32));
  i[e] = static_cast<int>(static_cast<unsigned>(key));
}

template <bool kIndex, int R>
cudaError_t launch_r(const Fwd& f, unsigned blocks, int threads, size_t shared,
                     cudaStream_t stream) {
  nn_kernel<kIndex, R><<<blocks, threads, shared, stream>>>(f);
  return cudaGetLastError();
}

// keys: chamfer_nn's scratch, b * (n + m) unsigned long long (rows, then
// columns), needed when a direction is merged; chamfer_nn_min merges into d1
// and d2 themselves (one memset when d2 follows d1 in memory)
template <bool kIndex>
int launch_nn(const void* x, const void* y, void* d1, void* i1, void* d2, void* i2, void* keys,
              int b, int n, int m, int tq, int tt, int r, int threads, int pack,
              cudaStream_t stream) {
  // pack 1: one tile over all warps; else pack / warps tiles a warp
  const int warps = threads / 32, wq = r > 0 ? tq / r : 0;
  const int per_warp = pack > 1 && warps > 0 ? pack / warps : 1;
  const int w = per_warp >= 1 && per_warp <= 32 && 32 % per_warp == 0 ? 32 / per_warp : 0;
  if (b < 1 || n < 1 || m < 1 || tt < 1 || (r != 1 && r != 2 && r != 4 && r != 8 && r != 16)
      || threads < 32 || threads > kMaxThreads || threads % 32 || pack < 1
      || (pack > 1 && pack % warps) || w < 1 || wq < 1 || wq * r != tq || (wq & (wq - 1))
      || w % wq)
    return static_cast<int>(cudaErrorInvalidValue);
  Fwd f{static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(d1),
        static_cast<int*>(i1), static_cast<float*>(d2), static_cast<int*>(i2), nullptr, nullptr,
        b, n, m, tq, tt, w, wq, w / wq, pack > 1 ? 1 : warps, pack,
        (n + tq - 1) / tq, (m + tt - 1) / tt};
  const size_t ks = sizeof(Key<kIndex>);
  const size_t shared = static_cast<size_t>(pack) * tt * (sizeof(float4) + ks)
                        + static_cast<size_t>(pack) * f.wpc * tq * ks;
  const long long tiles = static_cast<long long>(b) * f.qtiles * f.ttiles;
  const long long blocks = (tiles + pack - 1) / pack;
  if ((per_warp > 1 && (f.qtiles > 1 || f.ttiles > 1)) || shared > kMaxShared
      || tiles + pack > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool rows = f.ttiles > 1, cols = f.qtiles > 1;  // merged directions
  const long long n1 = static_cast<long long>(b) * n, n2 = static_cast<long long>(b) * m;
  cudaError_t err = cudaSuccess;
  if (kIndex && (rows || cols)) {
    if (keys == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    f.k1 = rows ? keys : nullptr;
    f.k2 = cols ? static_cast<unsigned long long*>(keys) + n1 : nullptr;
    err = cudaMemsetAsync(keys, 0xff, (n1 + n2) * ks, stream);
  } else if (!kIndex) {
    f.k1 = rows ? d1 : nullptr;
    f.k2 = cols ? d2 : nullptr;
    if (rows && cols && static_cast<float*>(d2) == static_cast<float*>(d1) + n1) {
      err = cudaMemsetAsync(d1, 0xff, (n1 + n2) * ks, stream);
    } else {
      if (rows) err = cudaMemsetAsync(d1, 0xff, n1 * ks, stream);
      if (cols && err == cudaSuccess) err = cudaMemsetAsync(d2, 0xff, n2 * ks, stream);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned nb = static_cast<unsigned>(blocks);
  switch (r) {
    case 1: err = launch_r<kIndex, 1>(f, nb, threads, shared, stream); break;
    case 2: err = launch_r<kIndex, 2>(f, nb, threads, shared, stream); break;
    case 4: err = launch_r<kIndex, 4>(f, nb, threads, shared, stream); break;
    case 8: err = launch_r<kIndex, 8>(f, nb, threads, shared, stream); break;
    default: err = launch_r<kIndex, 16>(f, nb, threads, shared, stream); break;
  }
  if (err != cudaSuccess || !kIndex || !(rows || cols)) return static_cast<int>(err);
  const long long u1 = rows ? n1 : 0, u2 = cols ? n2 : 0;
  unpack_kernel<<<static_cast<unsigned>((u1 + u2 + 255) / 256), 256, 0, stream>>>(
      static_cast<const unsigned long long*>(keys), static_cast<float*>(d1),
      static_cast<int*>(i1), u1, static_cast<const unsigned long long*>(keys) + n1,
      static_cast<float*>(d2), static_cast<int*>(i2), u2);
  return static_cast<int>(cudaGetLastError());
}

__global__ void bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           const int* __restrict__ i1, const int* __restrict__ i2,
                           const float* __restrict__ g1, const float* __restrict__ g2,
                           float* dx, float* dy, int b, int n, int m) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long rows_x = static_cast<long long>(b) * n;
  if (t >= rows_x + static_cast<long long>(b) * m) return;
  const bool from_y = t >= rows_x;
  const long long r = from_y ? t - rows_x : t;  // the point's row in (B, nq)
  const int nq = from_y ? m : n, nt = from_y ? n : m;
  const int j = (from_y ? i2 : i1)[r];
  const float g = (from_y ? g2 : g1)[r];
  const float* q = (from_y ? y : x) + r * 3;
  float* own = (from_y ? dy : dx) + r * 3;
  if (j < 0 || j >= nt) {
    for (int k = 0; k < 3; ++k) atomicAdd(own + k, NAN);
    return;
  }
  const long long partner = ((r / nq) * nt + j) * 3;
  const float* p = (from_y ? x : y) + partner;
  float* other = (from_y ? dx : dy) + partner;
  for (int k = 0; k < 3; ++k) {
    const float v = __fmul_rn(__fmul_rn(2.f, __fsub_rn(q[k], p[k])), g);
    atomicAdd(own + k, v);
    atomicAdd(other + k, -v);
  }
}

}  // namespace

extern "C" {

// x (B, N, 3), y (B, M, 3) f32 -> d1 (B, N) f32, i1 (B, N) int32, d2 (B, M)
// f32, i2 (B, M) int32; contiguous on the device, B, N, M >= 1. keys: scratch
// of B * (N + M) unsigned long long when N > tq or M > tt, else null. The
// tiling (tq, tt, r, threads, pack) is ops/chamfer.py launch_geometry's.
// Returns the first cudaError_t of the memset and the launches.
int act_chamfer_nn(const void* x, const void* y, void* d1, void* i1, void* d2, void* i2,
                   void* keys, int b, int n, int m, int tq, int tt, int r, int threads,
                   int pack, void* stream) {
  return launch_nn<true>(x, y, d1, i1, d2, i2, keys, b, n, m, tq, tt, r, threads, pack,
                         static_cast<cudaStream_t>(stream));
}

// As act_chamfer_nn without the indices and without scratch.
int act_chamfer_nn_min(const void* x, const void* y, void* d1, void* d2, int b, int n, int m,
                       int tq, int tt, int r, int threads, int pack, void* stream) {
  return launch_nn<false>(x, y, d1, nullptr, d2, nullptr, nullptr, b, n, m, tq, tt, r, threads,
                          pack, static_cast<cudaStream_t>(stream));
}

// x (B, N, 3), y (B, M, 3) f32, i1 (B, N), i2 (B, M) int32, g1 (B, N), g2
// (B, M) f32 -> dx (B, N, 3), dy (B, M, 3) f32 (zeroed here first);
// contiguous on the device. Returns the first cudaError_t of the memsets and
// the launch.
int act_chamfer_bwd(const void* x, const void* y, const void* i1, const void* i2,
                    const void* g1, const void* g2, void* dx, void* dy, int b, int n, int m,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(b) * n + static_cast<long long>(b) * m;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaMemsetAsync(dx, 0, static_cast<size_t>(b) * n * 3 * sizeof(float), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dy, 0, static_cast<size_t>(b) * m * 3 * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  bwd_kernel<<<static_cast<unsigned>((rows + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const int*>(i1),
      static_cast<const int*>(i2), static_cast<const float*>(g1), static_cast<const float*>(g2),
      static_cast<float*>(dx), static_cast<float*>(dy), b, n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
