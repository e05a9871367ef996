// Greedy farthest-point sampling on Hopper (sm_90a).
//
// Replaces: act_tpu/ops/fps.py::_fps_kernel_batched (its pallas_call at
// fps.py:186) and, at start index 0, act_tpu/ops/fps.py::_fps_kernel.
//
// Bound: the S-step loop is sequential. Each step needs the whole cloud's
// running minimum before the next center is known, so the time is S times
// the latency of one step: the distance update of a slice of the cloud, a
// cloud-wide (max, first index) reduction and the exchange behind it. Neither
// bytes (the cloud is read once) nor arithmetic (8 flops a point a step)
// bound it at these sizes.
//
// Design: one cloud runs on a thread-block cluster of C blocks (C = 1, 2, 4
// or 8, chosen by the wrapper so that the B*C blocks fit the card's SMs in
// one wave while each keeps at least 1024 points). Block r of the cluster owns a
// contiguous slice of the cloud and keeps its points (coordinates and
// running minimum distance) in registers, PPT a thread; every block holds
// the whole cloud's coordinates in shared memory to look the next center up.
// A step:
//  1. each thread updates its points and takes its first maximum by a tree;
//  2. each warp reduces a 64-bit key, (float bits of d) << 32 | ~index, with
//     two redux instructions (largest d, then smallest index among them):
//     running distances are >= +0, so unsigned order is value order, and the
//     larger ~index is the smaller index, so the first argmax is the largest
//     key; a padding lane has key 0;
//  3. lane r < C stores the warp's key into block r of the cluster with
//     st.async, which completes 8 bytes on that block's mbarrier; the key
//     slots and the two mbarriers alternate by step parity;
//  4. every thread waits on its own block's mbarrier for the C*W keys of the
//     step (one block: a plain store and __syncthreads);
//  5. every warp takes the largest key (redux over the lanes, or at one block
//     with at most 8 keys each lane reads them all) and the next center's
//     coordinates from shared memory.
// One wait a step, no cluster-wide barrier, no warp-0-only stage and no
// device-memory load on the critical path. The distance is
// ((dx*dx + dy*dy) + dz*dz) in f32 with each operation rounded on its own
// (no FMA contraction), like fps.py:128 and the plain version.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;  // no point: the index of a padding lane
constexpr unsigned SLOT_BYTES = 8;     // (d bits) << 32 | ~index

// Dynamic shared memory of a block: the key slots (2 parities x C*W), the two
// mbarriers and the coordinates of the whole cloud.
__host__ __device__ inline size_t fps_smem_bytes(int cw, int n) {
  return (size_t)2 * cw * SLOT_BYTES + 2 * sizeof(unsigned long long) +
         (size_t)3 * n * sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// A store into a block of the cluster that completes its bytes on that
// block's mbarrier.
__device__ __forceinline__ void st_async(unsigned addr, unsigned long long v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               ::"r"(addr), "l"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}" ::"r"(bar), "r"(parity) : "memory");
}

// The warp's lane holding the largest hi and, among those, the smallest j:
// two redux and a ballot.
__device__ __forceinline__ int warp_winner(unsigned hi, unsigned j) {
  const unsigned hmax = __reduce_max_sync(FULL, hi);
  const unsigned jmin = __reduce_min_sync(FULL, hi == hmax ? j : NONE);
  return __ffs(__ballot_sync(FULL, hi == hmax && j == jmin)) - 1;
}

// The largest of the cw keys at k, read by every lane (broadcast loads, four
// running maxima).
__device__ __forceinline__ unsigned long long max_key(const unsigned long long* k, int cw) {
  unsigned long long m0 = 0, m1 = 0, m2 = 0, m3 = 0;
  int q = 0;
  if ((cw & 3) == 0) {  // then k is 16-byte aligned
    for (; q < cw; q += 4) {
      const ulonglong2 a = *reinterpret_cast<const ulonglong2*>(k + q);
      const ulonglong2 b = *reinterpret_cast<const ulonglong2*>(k + q + 2);
      m0 = max(m0, a.x);
      m1 = max(m1, a.y);
      m2 = max(m2, b.x);
      m3 = max(m3, b.y);
    }
  }
  for (; q < cw; ++q) m0 = max(m0, k[q]);
  return max(max(m0, m1), max(m2, m3));
}

// MBAR (a cluster of C > 1 blocks): keys travel by st.async and each block
// waits on its own mbarrier for the C*W keys of the step; else (one block)
// by plain stores and __syncthreads, and at most 8 keys are read by every
// lane itself.
template <int PPT, int MAXT, bool MBAR>
__global__ void __launch_bounds__(MAXT)
fps_kernel(const float* __restrict__ pts, const int* __restrict__ start,
           int* __restrict__ out, int n, int s_total, int slice) {
  extern __shared__ unsigned long long smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int cw = csize * nw;
  unsigned long long* s_key = smem;                // [2][cw]
  unsigned long long* s_bar = s_key + 2 * cw;      // [2]
  float* s_xyz = reinterpret_cast<float*>(s_bar + 2);  // [n][3], the whole cloud
  const float* p = pts + (size_t)b * n * 3;
  int* o = out + (size_t)b * s_total;
  const int base = rank * slice;
  const int lim = min(n - base, slice);  // points of this block's slice

  for (int q = tid; q < 3 * n; q += nt) s_xyz[q] = p[q];
  float x[PPT], y[PPT], z[PPT], d[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int l = i * nt + tid;
    if (l < lim) {
      x[i] = p[3 * (base + l)];
      y[i] = p[3 * (base + l) + 1];
      z[i] = p[3 * (base + l) + 2];
      d[i] = INFINITY;
    } else {  // padding: -1 never beats a real distance (>= 0)
      x[i] = y[i] = z[i] = 0.f;
      d[i] = -1.f;
    }
  }

  int cur = start[b];
  cur = cur < 0 ? 0 : (cur >= n ? n - 1 : cur);
  if (rank == 0 && tid == 0) o[0] = cur;
  float cx = __ldg(p + 3 * cur);
  float cy = __ldg(p + 3 * cur + 1);
  float cz = __ldg(p + 3 * cur + 2);
  if (MBAR && tid == 0) {
    mbar_init(smem_addr(s_bar));
    mbar_init(smem_addr(s_bar + 1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // barriers set, the cloud staged, every block's shared memory live
  if (MBAR) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  // lane r < C sends the warp's key to block r
  const unsigned key_base = cluster_addr(smem_addr(s_key), lane < (int)csize ? lane : 0);
  const unsigned bar_base = cluster_addr(smem_addr(s_bar), lane < (int)csize ? lane : 0);

  for (int s = 1; s < s_total; ++s) {
    const int par = s & 1;
    if (MBAR && tid == 0) mbar_expect(smem_addr(s_bar + par), cw * SLOT_BYTES);
    float td[PPT];
    int ti[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float dx = __fsub_rn(x[i], cx);
      const float dy = __fsub_rn(y[i], cy);
      const float dz = __fsub_rn(z[i], cz);
      const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      d[i] = fminf(d[i], dd);
      td[i] = d[i];
      ti[i] = i;
    }
    // the thread's first maximum by a tree: the right (later) candidate wins
    // only when strictly larger
#pragma unroll
    for (int w = 1; w < PPT; w <<= 1) {
#pragma unroll
      for (int i = 0; i + w < PPT; i += 2 * w) {
        if (td[i + w] > td[i]) {
          td[i] = td[i + w];
          ti[i] = ti[i + w];
        }
      }
    }
    const float best = td[0];
    const bool real = best >= 0.f;  // else this thread holds padding only
    const unsigned hi = real ? __float_as_uint(best) : 0u;
    const unsigned j = real ? (unsigned)(base + ti[0] * nt + tid) : NONE;
    const int wl = warp_winner(hi, j);
    // an all-padding warp sends key 0, which every real point (~j >= 1) beats
    const unsigned long long key =
        __shfl_sync(FULL, ((unsigned long long)hi << 32) | (unsigned)~j, wl);
    const int slot = par * cw + rank * nw + warp;
    if (MBAR) {
      if (lane < (int)csize) {
        st_async(key_base + slot * SLOT_BYTES, key, bar_base + par * sizeof(unsigned long long));
      }
      mbar_wait(smem_addr(s_bar + par), ((s - 1) >> 1) & 1);
    } else {
      if (lane == 0) s_key[slot] = key;
      __syncthreads();
    }
    // every warp reduces the cw keys: (d bits, then ~index) largest wins
    unsigned win;
    if (!MBAR && cw <= 8) {
      win = ~(unsigned)max_key(s_key + par * cw, cw);
    } else {
      unsigned long long bk = 0;
      for (int q = lane; q < cw; q += 32) bk = max(bk, s_key[par * cw + q]);
      const unsigned bj = ~(unsigned)bk;  // the winner's index, or NONE (no key)
      win = __shfl_sync(FULL, bj, warp_winner((unsigned)(bk >> 32), bj));
    }
    cx = s_xyz[3 * win];
    cy = s_xyz[3 * win + 1];
    cz = s_xyz[3 * win + 2];
    if (rank == 0 && tid == 0) o[s] = (int)win;
  }
}

using Kernel = void (*)(const float*, const int*, int*, int, int, int);

// The instantiation for ppt points a thread and C blocks a cloud; at 16
// points a thread a block of at most 512 threads may use 128 registers a
// thread and keeps its points out of local memory.
template <bool MBAR>
Kernel pick_ppt(int ppt, int threads) {
  switch (ppt) {
    case 1: return fps_kernel<1, 1024, MBAR>;
    case 2: return fps_kernel<2, 1024, MBAR>;
    case 4: return fps_kernel<4, 1024, MBAR>;
    case 8: return fps_kernel<8, 1024, MBAR>;
    case 16: return threads <= 512 ? fps_kernel<16, 512, MBAR> : fps_kernel<16, 1024, MBAR>;
    default: return nullptr;
  }
}

Kernel pick(int c, int ppt, int threads) {
  return c > 1 ? pick_ppt<true>(ppt, threads) : pick_ppt<false>(ppt, threads);
}

cudaError_t prepare(Kernel kernel, int c, int threads, int n, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr) {
  const size_t smem = fps_smem_bytes(c * (threads / 32), n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

bool geometry_ok(int n, int c, int threads, int ppt) {
  const int slice = (n + c - 1) / c;
  return (c == 1 || c == 2 || c == 4 || c == 8) && threads >= 32 && threads <= 1024 &&
         threads % 32 == 0 && (long long)threads * ppt >= slice &&
         fps_smem_bytes(c * (threads / 32), n) <= 227 * 1024;
}

}  // namespace

extern "C" {

// pts (B, N, 3) f32, start (B,) int32, out (B, S) int32; all contiguous on
// the device; N <= 16384 (the cloud in shared memory). One cloud runs on a
// cluster of c blocks of `threads` threads, ppt points a thread (1, 2, 4, 8
// or 16); c * threads * ppt >= N. Returns the cudaError_t of the launch.
int act_fps(const void* pts, const void* start, void* out, int b, int n, int s, int c,
            int threads, int ppt, void* stream) {
  const Kernel kernel = pick(c, ppt, threads);
  if (!kernel || !geometry_ok(n, c, threads, ppt)) return (int)cudaErrorInvalidValue;
  const int slice = (n + c - 1) / c;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare(kernel, c, threads, n, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(b * c);
  cfg.stream = static_cast<cudaStream_t>(stream);
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(pts),
                         static_cast<const int*>(start), static_cast<int*>(out), n, s, slice);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of this geometry the card runs at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
int act_fps_max_clusters(int n, int c, int threads, int ppt) {
  const Kernel kernel = pick(c, ppt, threads);
  if (!kernel || !geometry_ok(n, c, threads, ppt)) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare(kernel, c, threads, n, &cfg, &attr);
  if (e != cudaSuccess) return -(int)e;
  cfg.gridDim = dim3(c);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
