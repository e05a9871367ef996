// Hard Gumbel sample, argmax(logits + Gumbel noise) over the last axis, on
// Hopper (sm_90a).
//
// Replaces: act_tpu/ops/sampling.py::_gumbel_argmax_kernel (its pallas_call at
// sampling.py:91), reached from the frozen tokenizer's hard sample
// (act_tpu/models/dvae.py:90-101).
//
// Noise: the counter hash of the JAX kernel's interpret path
// (sampling.py:33-42), value for value. For row-in-chunk r, chunk index pid
// (the chunk of _gumbel_rows, sampling.py:84-88, passed in by the wrapper),
// lane and seed words s0, s1, in wrapping 32-bit arithmetic with logical
// shifts:
//   h = r*0x9E3779B9 + lane*40503 + s0*69069 + s1*1013904223 + pid*22695477
//       + 374761393;  h ^= h << 13;  h ^= h >> 17;  h ^= h << 5;  bits = h >> 1
//   u = max(f32(bits) * 2^-31, 1e-10);  val = f32(logit) + (-log(-log(u)))
// The result is the first index of the largest val. NaN ranks above every
// number, as in torch.argmax. Built without --use_fast_math and with logf, so
// the logs equal torch.log on the card bit for bit and the plain version
// (ops/reference.py::gumbel_argmax_ref) agrees exactly.
//
// Bound: the logits are read once (rows*V*2 bytes in bf16) and only rows int32
// ids are written, so at (8192, 8192) bf16 bytes bound it: 134 MB, 0.040 ms at
// 3.35 TB/s. Operations per element, counted from the expression above: 14
// for the hash (2 for lane*40503 plus the add to the row's base, 6 for the
// three shift-xors, 1 for the last shift, counted as 1 each; the row's base is
// once a row), 1 convert, 1 multiply, 1 max, 2 logs, 2 negations, 1 bf16
// convert, 1 add, 1 compare: 24, 0.024 ms at 67 TF/s.
//
// Design: one block of 256 threads per row. Each thread walks its strided
// share of the row in 16-byte loads (8 bf16 or 4 f32 lanes), draws the noise
// in registers and keeps a private (max, first index) pair; a warp-shuffle
// reduction and one warp over the eight warp winners finish the row, ties to
// the smaller index. The uniform tensor the XLA form writes and reads back
// (268 MB of f32 at the path shape) never exists.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// (v, i) beats (bv, bi): NaN above all numbers, larger first, then smaller index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float perturbed(float logit, uint32_t base, int lane) {
  uint32_t h = base + static_cast<uint32_t>(lane) * 40503u;
  h ^= h << 13;
  h ^= h >> 17;
  h ^= h << 5;
  const int bits = static_cast<int>(h >> 1);
  const float u = fmaxf(static_cast<float>(bits) * 0x1p-31f, 1e-10f);
  return logit + (-logf(-logf(u)));
}

template <typename T>
__device__ __forceinline__ void consider(T x, uint32_t base, int lane, float& bv, int& bi) {
  const float val = perturbed(to_f32(x), base, lane);
  if (better(val, lane, bv, bi)) {
    bv = val;
    bi = lane;
  }
}

// VEC lanes per 16-byte load; VEC == 1 takes one element at a time (ragged V
// or a row that is not 16-byte aligned)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gumbel_argmax_kernel(const T* __restrict__ logits, const int* __restrict__ seed,
                     int* __restrict__ out, int v, int chunk) {
  const int row = blockIdx.x;
  const int pid = row / chunk;
  const int r = row - pid * chunk;
  const uint32_t base = static_cast<uint32_t>(r) * 2654435769u
                        + static_cast<uint32_t>(seed[0]) * 69069u
                        + static_cast<uint32_t>(seed[1]) * 1013904223u
                        + static_cast<uint32_t>(pid) * 22695477u + 374761393u;
  const T* x = logits + static_cast<size_t>(row) * v;
  float bv = -INFINITY;
  int bi = INT_MAX;
  if (VEC > 1) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int j = threadIdx.x; j < v / VEC; j += kThreads) {
      const uint4 pk = xv[j];
      const T* e = reinterpret_cast<const T*>(&pk);
#pragma unroll
      for (int q = 0; q < VEC; ++q) consider(e[q], base, j * VEC + q, bv, bi);
    }
  } else {
    for (int lane = threadIdx.x; lane < v; lane += kThreads) consider(x[lane], base, lane, bv, bi);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  if (lane_id == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return;
  bv = lane_id < kThreads / 32 ? wv[lane_id] : -INFINITY;
  bi = lane_id < kThreads / 32 ? wi[lane_id] : INT_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane_id == 0) out[row] = bi;
}

template <typename T>
int launch(const void* logits, const void* seed, void* out, int rows, int v, int chunk,
           cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  const bool aligned = v % vec == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  const T* x = static_cast<const T*>(logits);
  const int* s = static_cast<const int*>(seed);
  int* o = static_cast<int*>(out);
  if (aligned)
    gumbel_argmax_kernel<T, vec><<<rows, kThreads, 0, stream>>>(x, s, o, v, chunk);
  else
    gumbel_argmax_kernel<T, 1><<<rows, kThreads, 0, stream>>>(x, s, o, v, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// logits (rows, V) bf16 (is_bf16 = 1) or f32, contiguous on the device; seed
// (2,) int32 on the device; out (rows,) int32. rows >= 1, V >= 1, chunk >= 1.
// Returns the cudaError_t of the launch.
int act_gumbel_argmax(const void* logits, const void* seed, void* out, int rows, int v,
                      int chunk, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(logits, seed, out, rows, v, chunk, st)
                 : launch<float>(logits, seed, out, rows, v, chunk, st);
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
