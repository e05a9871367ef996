// The backward of a row gather, summed in a fixed order, on Hopper (sm_90a).
//
// Replaces no Pallas kernel. It repairs the port's own backward: the DGCNN's
// neighbour rows (models/common.py, (B, G*k, C) rows of (B, G, C)) and the 3-NN
// blend's three feature gathers (ops/reference.py nn_blend, (B, N, C) rows of
// (B, S, C)) were torch.gather / index_select, whose backward on CUDA adds with
// atomics in an order that changes from run to run, so no Stage-I or
// segmentation step repeated bit for bit on the card. On a TPU the JAX package
// gathers by a one-hot product and its backward is a product too.
//
// Function: out[b, s, :] = sum over m ascending with idx[b, m] == s of
// grad[b, m, :], accumulated in f32 from +0 and rounded once to the gradient's
// type (f32 or bf16): the sum and order of ops/reference.py
// gather_rows_bwd_ref, so the kernel equals its plain version bit for bit; in
// f32 both equal torch.gather's and index_select's backward on the CPU. An
// index outside [0, S) adds nothing.
//
// Bound: bytes. The gradient rows are read once and the summed rows written
// once (a Stage-I DGCNN round at B=64, G=64, k=4, C=512 in f32: 33.6 MB in,
// 8.4 MB out, 12.5 us at 3.35 TB/s; one of part seg's three 3-NN gathers at
// B=16, N=2048, S=128, C=1152 in f32: 151 MB in, 9.4 MB out, 48 us); one f32
// sum an element is far below the card's rate.
//
// Design. Two kernels on the caller's stream, no global atomic and no memset:
// 1. csr_kernel, one block a cloud, lists each destination's sources (a CSR:
//    the starts, then the sources in ascending order). The cloud's sources are
//    split into W contiguous chunks, one warp each (W = 8 while W counters a
//    destination fit in shared memory); each warp counts its chunk's
//    destinations (shared-memory integer atomics: the counts do not depend on
//    their order); one exclusive scan over (destination, warp), spread over
//    the block, gives every warp its first slot in every destination's list
//    and the starts; then each warp walks its chunk 32 sources at a time in
//    ascending order, __match_any_sync grouping the lanes of one destination
//    and each lane's rank among the lower lanes of its group placing it.
//    Chunk w's sources precede chunk w+1's and take the lower slots, so each
//    list is ascending. A caller whose indices were listed by an earlier
//    launch (the DGCNN's four rounds share one set) passes build = 0 and the
//    same order and starts, and this kernel is not run.
// 2. sum_kernel, one warp a destination: lanes across the channels (4 a lane,
//    128 a pass, coalesced loads), the destination's sources walked in list
//    order four at a time (their 16 loads issued together, then added in
//    list order), each channel's sum in a register.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 8192;     // destinations a cloud: S counters in shared memory
constexpr int kCsrThreads = 256;
constexpr int kCsrWarps = kCsrThreads / 32;
constexpr int kCsrSmem = 48 * 1024;  // the shared memory a block gets without opting in
constexpr int kSumWarps = 8;       // destinations a block of sum_kernel
constexpr int kVec = 4;            // channels a lane a pass
constexpr int kUnroll = 4;         // sources whose loads are issued together
constexpr unsigned kFull = 0xffffffffu;

// The warps that list a cloud's sources: W counters for each of s destinations,
// beside the scan's kCsrWarps partial sums, in kCsrSmem bytes.
inline int csr_warps(int s) {
  const int fit = (kCsrSmem / static_cast<int>(sizeof(int)) - kCsrWarps) / (s > 0 ? s : 1);
  return fit < 1 ? 1 : (fit > kCsrWarps ? kCsrWarps : fit);
}

__global__ void __launch_bounds__(kCsrThreads)
csr_kernel(const int* __restrict__ idx, int* __restrict__ order, int* __restrict__ starts,
           int m, int s, int w_count) {
  // slot[w * s + d]: warp w's count of destination d, then its next slot there
  extern __shared__ int smem[];
  int* slot = smem;
  int* partial = smem + w_count * s;
  const long long b = blockIdx.x;
  const int* ib = idx + b * m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (m + w_count - 1) / w_count;
  for (int e = tid; e < w_count * s; e += blockDim.x) slot[e] = 0;
  __syncthreads();
  if (warp < w_count) {
    const int lo = warp * chunk, hi = min(m, lo + chunk);
    for (int i = lo + lane; i < hi; i += 32) {
      const int d = __ldg(ib + i);
      if (d >= 0 && d < s) atomicAdd(slot + warp * s + d, 1);
    }
  }
  __syncthreads();
  // exclusive scan over (d, w) in that order: thread t takes destinations [d0, d1)
  const int per = (s + blockDim.x - 1) / blockDim.x;
  const int d0 = min(s, tid * per), d1 = min(s, d0 + per);
  int local = 0;
  for (int d = d0; d < d1; ++d)
    for (int w = 0; w < w_count; ++w) local += slot[w * s + d];
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) partial[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += partial[w];
  int run = before + incl - local;
  int* sb = starts + b * (s + 1);
  for (int d = d0; d < d1; ++d) {
    sb[d] = run;
    for (int w = 0; w < w_count; ++w) {
      const int c = slot[w * s + d];
      slot[w * s + d] = run;
      run += c;
    }
  }
  if (tid == blockDim.x - 1) sb[s] = run;  // the last thread's run is the total
  __syncthreads();
  if (warp >= w_count) return;
  int* ob = order + b * m;
  int* cursor = slot + warp * s;
  const int lo = warp * chunk, hi = min(m, lo + chunk);
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const int d = i < hi ? __ldg(ib + i) : -1;
    const bool ok = d >= 0 && d < s;
    const unsigned peers = __match_any_sync(kFull, ok ? d : -1);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (ok) ob[cursor[d] + rank] = i;
    __syncwarp();  // every lane has read its cursor before the group's first lane moves it
    if (ok && lane == __ffs(peers) - 1) cursor[d] += __popc(peers);
    __syncwarp();
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32)
sum_kernel(const T* __restrict__ grad, const int* __restrict__ order,
           const int* __restrict__ starts, T* __restrict__ out, int m, int s, int c) {
  const int d = blockIdx.x * kSumWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (d >= s) return;
  const long long b = blockIdx.y;
  const int* sb = starts + b * (s + 1);
  const int j0 = __ldg(sb + d), j1 = __ldg(sb + d + 1);
  const int* ob = order + b * m;
  const T* gb = grad + b * m * static_cast<long long>(c);
  T* row_out = out + (b * s + d) * static_cast<long long>(c);
  for (int c0 = 0; c0 < c; c0 += 32 * kVec) {
    float acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = 0.0f;
    int j = j0;
    for (; j + kUnroll <= j1; j += kUnroll) {
      float x[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* row = gb + static_cast<long long>(__ldg(ob + j + u)) * c;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int ch = c0 + lane + 32 * v;
          x[u][v] = ch < c ? to_f32(row[ch]) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[v] = __fadd_rn(acc[v], x[u][v]);
    }
    for (; j < j1; ++j) {
      const T* row = gb + static_cast<long long>(__ldg(ob + j)) * c;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int ch = c0 + lane + 32 * v;
        if (ch < c) acc[v] = __fadd_rn(acc[v], to_f32(row[ch]));
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int ch = c0 + lane + 32 * v;
      if (ch < c) row_out[ch] = from_f32<T>(acc[v]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* grad, const int* idx, void* out, int* order, int* starts, int b,
                   int m, int s, int c, bool build, cudaStream_t stream) {
  if (build) {
    const int w = csr_warps(s);
    csr_kernel<<<b, kCsrThreads, (w * s + kCsrWarps) * sizeof(int), stream>>>(
        idx, order, starts, m, s, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (c == 0) return cudaSuccess;
  sum_kernel<T><<<dim3((s + kSumWarps - 1) / kSumWarps, b), kSumWarps * 32, 0, stream>>>(
      static_cast<const T*>(grad), order, starts, static_cast<T*>(out), m, s, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// grad (B, M, C) of dtype (0: f32, 1: bf16), idx (B, M) int32, out (B, S, C)
// of grad's dtype; the CSR order (B, M) and starts (B, S + 1) int32, listed
// from idx here when build is 1, else read as an earlier launch on the same
// idx, B, M and S left them; all contiguous on the device, S at most 8192, B
// at most 65535. Returns the cudaError_t of the launches.
int act_row_gather_bwd(const void* grad, const void* idx, void* out, void* order, void* starts,
                       int b, int m, int s, int c, int dtype, int build, void* stream) {
  if (b < 0 || b > 65535 || m < 0 || s < 0 || s > kMaxRows || c < 0 || dtype < 0 || dtype > 1
      || build < 0 || build > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || s == 0) return static_cast<int>(cudaSuccess);
  const int* i = static_cast<const int*>(idx);
  int* o = static_cast<int*>(order);
  int* st = static_cast<int*>(starts);
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
      ? launch<float>(grad, i, out, o, st, b, m, s, c, build == 1, strm)
      : launch<__nv_bfloat16>(grad, i, out, o, st, b, m, s, c, build == 1, strm);
  return static_cast<int>(err);
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
