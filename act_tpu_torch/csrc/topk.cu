// Per-row k smallest on Hopper (sm_90a).
//
// Replaces: act_tpu/ops/topk.py::_ksmallest_kernel (its pallas_call at
// topk.py:84), reached from the group kNN (act_tpu/ops/group.py:_knn_tpu).
//
// Bound: reading the (rows, N) f32 matrix once is the least work, so bytes
// bound it; k << N selection rounds then run out of shared memory.
//
// Design: one warp per row, several rows per block. The warp copies its row
// into shared memory once, as order keys: unsigned integers that compare like
// the floats, with -0 equal to +0 and every NaN above +inf, which is where a
// stable ascending sort puts them. Each lane keeps the (key, index) minimum of
// its own strided slice of the row. A round is one warp-wide (min key,
// smallest index) butterfly reduction; the lane that owned the winner writes
// it out (the value read back from the input, bit for bit), marks it TAKEN,
// a key above every value's, and rescans only its slice. Rounds emit in
// ascending order, ties to the smaller index, like a stable ascending sort.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr unsigned TAKEN = 0xffffffffu;

__device__ __forceinline__ unsigned order_key(float v) {
  if (isnan(v)) return TAKEN - 1u;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool better(unsigned v, int i, unsigned bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void ksmallest_kernel(const float* __restrict__ d,
                                 float* __restrict__ vals,
                                 int* __restrict__ idxs, int rows, int n,
                                 int k) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // whole warp leaves; the kernel has no block sync
  unsigned* srow = smem + (size_t)warp * n;
  const float* g = d + (size_t)row * n;

  unsigned lv = TAKEN;
  int li = INT_MAX;
  for (int j = lane; j < n; j += 32) {  // each lane owns j = lane mod 32
    const unsigned v = order_key(g[j]);
    srow[j] = v;
    if (better(v, j, lv, li)) {
      lv = v;
      li = j;
    }
  }

  float* vrow = vals + (size_t)row * k;
  int* irow = idxs + (size_t)row * k;
  // k <= n leaves an untaken entry in every round, and any untaken key beats
  // what a lane with an all-taken slice offers (TAKEN), so bi is always real.
  for (int r = 0; r < k; ++r) {
    unsigned bv = lv;
    int bi = li;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (li == bi) {  // the owner lane emits and retires the winner
      vrow[r] = g[bi];
      irow[r] = bi;
      srow[bi] = TAKEN;
      lv = TAKEN;
      li = INT_MAX;
      for (int j = lane; j < n; j += 32) {
        const unsigned v = srow[j];
        if (better(v, j, lv, li)) {
          lv = v;
          li = j;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// d (rows, N) f32, vals (rows, k) f32, idxs (rows, k) int32; contiguous on
// the device; 1 <= k <= N <= 58112 (one row in a block's 227 KB of shared
// memory). Returns the cudaError_t of the launch.
int act_ksmallest(const void* d, void* vals, void* idxs, int rows, int n, int k,
                  void* stream) {
  int warps = (48 * 1024) / (n * 4);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = (size_t)warps * n * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ksmallest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((rows + warps - 1) / warps), block(warps * 32);
  ksmallest_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<float*>(vals),
      static_cast<int*>(idxs), rows, n, k);
  return static_cast<int>(cudaGetLastError());
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
