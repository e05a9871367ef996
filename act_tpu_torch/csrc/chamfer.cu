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
// indices are exact, ties included: a candidate replaces the best only when it
// is strictly smaller, so the first index of the minimum wins in both
// directions, as chamfer.py:75-79 and torch.argmin choose. Coordinates must
// be finite.
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
// Design of the forward. The TPU kernel takes the row and the column minima of
// one distance tile, carrying the column minima in VMEM scratch across its
// sequential query-tile grid axis. On Hopper blocks run in parallel and
// nothing carries over, so each direction is its own row-minimum pass, both in
// one launch: the first blocks take the points of x as queries against y, the
// rest the points of y against x. Every distance is computed twice, twice the
// arithmetic of the TPU's one pass (the bound counts it once), which at the
// recon loss's sizes costs a microsecond.
// A thread owns one query point, kept in registers with its (min, index)
// pair; the block stages the other cloud in shared memory, 1024 points a tile
// as float4 (16 KB), which its threads read as broadcasts. Small clouds are
// packed, T / Nq clouds to a block of T threads (the recon loss's 4096
// problems: 32 clouds of 8 queries or 8 clouds of 32 a block); a large cloud
// is cut into query tiles of T. T is 256, halved down to 32 while the launch
// would give fewer than two blocks to each of the 132 SMs, so one validation
// cloud, (1, 2048)x(1, 1024), runs as 96 one-warp blocks instead of 12 blocks
// of 256 on 12 SMs. The ragged edge is masked: no padding, no sentinel
// coordinates. No atomics: the results are deterministic.
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
#include <math.h>

namespace {

constexpr int kTile = 1024;       // target points staged in shared memory a tile
constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 32;
constexpr int kSMs = 132;         // H100 SXM

// one direction: each point of q (clouds, nq, 3) against every point of t
// (clouds, nt, 3) of its cloud -> d, i (clouds, nq)
struct Pass {
  const float* q;
  const float* t;
  float* d;
  int* i;
  int nq, nt;
};

__host__ __device__ inline int query_width(int nq, int threads) {
  return nq < threads ? nq : threads;
}

// blocks of one pass: clouds packed threads / w to a block, nq / w query
// tiles a cloud
inline int pass_blocks(int clouds, int nq, int threads) {
  const int w = query_width(nq, threads);
  const int pack = threads / w;
  return ((clouds + pack - 1) / pack) * ((nq + w - 1) / w);
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float4 p) {
  const float dx = __fsub_rn(qx, p.x), dy = __fsub_rn(qy, p.y), dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <bool kIndex>
__global__ void __launch_bounds__(kMaxThreads)
nn_kernel(Pass first, Pass second, int clouds, int first_blocks) {
  __shared__ float4 tile[kTile];
  const bool in_second = blockIdx.x >= first_blocks;
  const Pass p = in_second ? second : first;
  const int blk = in_second ? blockIdx.x - first_blocks : blockIdx.x;
  const int w = query_width(p.nq, blockDim.x);  // queries of one cloud in the block
  const int pack = blockDim.x / w;               // clouds in the block
  const int qtiles = (p.nq + w - 1) / w;         // query tiles of one cloud
  const int group = blk / qtiles;
  const int slot = threadIdx.x / w;
  const int cloud = group * pack + slot;
  const int qi = (blk - group * qtiles) * w + (threadIdx.x - slot * w);
  const bool active = slot < pack && cloud < clouds && qi < p.nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* s = p.q + (static_cast<long long>(cloud) * p.nq + qi) * 3;
    qx = s[0];
    qy = s[1];
    qz = s[2];
  }
  const int per = kTile / pack;  // target points of one cloud a tile
  float best = INFINITY;
  int best_i = 0;
  for (int j0 = 0; j0 < p.nt; j0 += per) {
    const int cnt = min(per, p.nt - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < pack * per; e += blockDim.x) {
      const int s = e / per, j = e - s * per;
      const int c = group * pack + s;
      if (j < cnt && c < clouds) {
        const float* t = p.t + (static_cast<long long>(c) * p.nt + j0 + j) * 3;
        tile[e] = make_float4(t[0], t[1], t[2], 0.f);
      }
    }
    __syncthreads();
    if (active) {
      const float4* row = tile + slot * per;
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float d = sq_dist(qx, qy, qz, row[j]);
        if (d < best) {
          best = d;
          if constexpr (kIndex) best_i = j0 + j;
        }
      }
    }
  }
  if (active) {
    const long long o = static_cast<long long>(cloud) * p.nq + qi;
    p.d[o] = best;
    if constexpr (kIndex) p.i[o] = best_i;
  }
}

template <bool kIndex>
int launch_nn(const void* x, const void* y, void* d1, void* i1, void* d2, void* i2, int b,
              int n, int m, cudaStream_t stream) {
  int threads = kMaxThreads;
  while (threads > kMinThreads
         && pass_blocks(b, n, threads) + pass_blocks(b, m, threads) < 2 * kSMs)
    threads /= 2;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const Pass first{xf, yf, static_cast<float*>(d1), static_cast<int*>(i1), n, m};
  const Pass second{yf, xf, static_cast<float*>(d2), static_cast<int*>(i2), m, n};
  const int first_blocks = pass_blocks(b, n, threads);
  nn_kernel<kIndex><<<first_blocks + pass_blocks(b, m, threads), threads, 0, stream>>>(
      first, second, b, first_blocks);
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
// f32, i2 (B, M) int32; contiguous on the device, B, N, M >= 1. Returns the
// cudaError_t of the launch.
int act_chamfer_nn(const void* x, const void* y, void* d1, void* i1, void* d2, void* i2,
                   int b, int n, int m, void* stream) {
  return launch_nn<true>(x, y, d1, i1, d2, i2, b, n, m, static_cast<cudaStream_t>(stream));
}

// As act_chamfer_nn without the indices.
int act_chamfer_nn_min(const void* x, const void* y, void* d1, void* d2, int b, int n, int m,
                       void* stream) {
  return launch_nn<false>(x, y, d1, nullptr, d2, nullptr, b, n, m,
                          static_cast<cudaStream_t>(stream));
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
