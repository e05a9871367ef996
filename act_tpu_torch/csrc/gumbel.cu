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
//   u = max(f32(bits) * 2^-31, 1e-10);  val = f32(logit) + noise(bits),
//   noise(bits) = -log(-log(u))
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
// Design: screen every lane cheaply, decide exactly for the few that can win.
// The two accurate logfs cost ~40 issued instructions an element, so taking
// them for every lane made the one-block-a-row kernel issue-bound (0.178 ms at
// the path shape). noise() is non-decreasing in bits, so a table of buckets of
// bits with Glo = noise(first bits), Ghi = noise(last bits) brackets every
// lane's noise, and, rounding being monotone, its exact value: fl(logit + Glo)
// <= val <= fl(logit + Ghi). With T a lower bound of the row's maximum (the
// largest lower end seen), a lane whose upper end is below T can neither win
// nor tie; NaN upper ends (a NaN logit, or -inf + inf) survive the test `hi <
// T` as written. The table has three parts: entry 0, all bits below the cut b0
// = 2^31 - 2^23; 2^k buckets over [b0, 2^31), the candidates (the top 2^-8 of
// the bits, about 32 lanes a row at V = 8192); 2^k buckets over all bits. Per
// lane the kernel takes only the hash, one compare (candidate or not) and the
// running max of the logits (bf16 two lanes an instruction), without branches:
// below the cut fl(lmax + Glo[0]) bounds every lane from below and fl(lmax +
// Ghi[0]) from above, so a thread none of whose logits reaches T - Ghi[0] looks
// nothing up. The candidates (~4 in a warp's tile) take their top bucket's
// bounds; after T, they and the few lanes below the cut whose coarse bound
// reaches T are held to their bucket's upper bound, and the survivors (~1.1 a
// row at V = 8192 with randn logits) take noise() exactly and the usual (value,
// first index) fold. The table is built in shared memory once a block from the
// same noise(); the grid is persistent (4 blocks a SM walk the rows) to
// amortise it. act_gumbel_bound_check proves on the card, over all 2^31 bits and
// at every k, that noise() is non-decreasing and lies in both of its buckets
// (the device logf promises 1 ulp, not monotonicity); it holds with no margin,
// so the table is not widened.
//
// A warp takes a row and walks it in tiles of 32 threads x 4 16-byte loads
// (1024 bf16 or 512 f32 lanes), all loads of a tile issued before its
// arithmetic; 32 warps a SM keep the loads in flight (a register prefetch of
// the next tile cost more in registers than it hid). The cut is a compile-time
// constant, which keeps the kernel within 64 registers without spills. The
// warp's max of lo (fmaxf ignores NaN) runs across its tiles of the row:
// screening a tile against the max so far is still exact, as it is a lower
// bound of the row's maximum. The candidates and survivors re-read their logit
// (the tile's lines, just loaded; a 32-way register select was slower). Ties go
// to the smaller index through the NaN-aware compare.
//
// A ragged V, a row that is not 16-byte aligned (the scalar path) or a row
// shorter than a tile is not screened: a block of 256 threads a row takes every
// lane exactly, one element at a time, as the earlier kernel did. There a warp
// a row would pay its block's table for a part of a tile (on an H100 the sweep
// measured (300, 1000) bf16 at 0.0104 ms screened, against 0.0029 exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kLoads = 4;  // 16-byte loads a thread a tile of the screen
constexpr int kMinBits = 6, kMaxBits = 10;  // bucket bits k: a table of 2^(k+1) + 1 float2
constexpr int kCut = 8;                     // candidates: the top 2^-8 of the 31 bits
constexpr uint32_t kB0 = (1u << 31) - (1u << (31 - kCut));  // their first bits

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// max that returns NaN if either is NaN (fmaxf ignores one)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The running max of logits, NaN if any is NaN: one at a time, or bf16 a
// pair at a time (one instruction for two lanes)
template <typename T>
struct Max {
  static constexpr int kLanes = 1;
  float m = -INFINITY;
  __device__ __forceinline__ void add(const T* x) { m = max_nan(m, to_f32(*x)); }
  __device__ __forceinline__ void merge(const Max& o) { m = max_nan(m, o.m); }
  __device__ __forceinline__ float value() const { return m; }
};
template <>
struct Max<__nv_bfloat16> {
  static constexpr int kLanes = 2;
  __nv_bfloat162 m = __bfloat162bfloat162(__float2bfloat16(-INFINITY));
  __device__ __forceinline__ void add(const __nv_bfloat16* x) {
    m = __hmax2_nan(m, *reinterpret_cast<const __nv_bfloat162*>(x));
  }
  __device__ __forceinline__ void merge(const Max& o) { m = __hmax2_nan(m, o.m); }
  __device__ __forceinline__ float value() const {
    return max_nan(__low2float(m), __high2float(m));
  }
};

// (v, i) beats (bv, bi): NaN above all numbers, larger first, then smaller index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// The Gumbel noise of a lane's 31 bits: the one expression that decides ids
// (separately rounded operations, so each inlined copy computes the same value)
__device__ __forceinline__ float noise(int bits) {
  const float u = fmaxf(__fmul_rn(static_cast<float>(bits), 0x1p-31f), 1e-10f);
  return -logf(-logf(u));
}

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h << 13;
  h ^= h >> 17;
  h ^= h << 5;
  return h;
}

// The row's hash base: the hash of lane l is mix(base + l * 40503), its bits
// that value >> 1
__device__ __forceinline__ uint32_t row_base(int row, int chunk, const int* seed) {
  const int pid = row / chunk;
  return static_cast<uint32_t>(row - pid * chunk) * 2654435769u
         + static_cast<uint32_t>(seed[0]) * 69069u
         + static_cast<uint32_t>(seed[1]) * 1013904223u
         + static_cast<uint32_t>(pid) * 22695477u + 374761393u;
}

// The table: entry 0 bounds every bits below the cut b0; entries 1 to 2^k
// split [b0, 2^31) into 2^k equal buckets (the candidates'); entries
// 2^k + 1 to 2^(k+1) split [0, 2^31) into 2^k equal buckets (for a lane below
// the cut whose logit is large enough to need a finer bound). For h = 2 bits
// + (0 or 1), the kernel takes a candidate's bucket (h >= 2 b0) as
// 1 + ((h >> (24 - k)) & (2^k - 1)) and the other as
// 2^k + 1 + (h >> (32 - k)).
__device__ __forceinline__ int top_bucket(uint32_t bits, int k) {
  return bits < kB0 ? 0 : 1 + static_cast<int>((bits - kB0) >> (31 - kCut - k));
}
__device__ __forceinline__ int all_bucket(uint32_t bits, int k) {
  return (1 << k) + 1 + static_cast<int>(bits >> (31 - k));
}

// table[b] = (noise at bucket b's first bits, noise at its last bits)
__device__ void build_table(float2* table, int k) {
  const int n = 1 << k;
  for (int b = threadIdx.x; b <= 2 * n; b += blockDim.x) {
    uint32_t first, end;  // bits [first, end)
    if (b == 0) {
      first = 0u;
      end = kB0;
    } else if (b <= n) {
      first = kB0 + (static_cast<uint32_t>(b - 1) << (31 - kCut - k));
      end = kB0 + (static_cast<uint32_t>(b) << (31 - kCut - k));
    } else {
      first = static_cast<uint32_t>(b - n - 1) << (31 - k);
      end = static_cast<uint32_t>(b - n) << (31 - k);
    }
    table[b] = make_float2(noise(static_cast<int>(first)), noise(static_cast<int>(end - 1u)));
  }
}

template <typename T>
struct alignas(16) Vec {  // the lanes of one 16-byte load
  T e[16 / sizeof(T)];
};

// (bv, bi) <- the better of it and lane `off` away, over a warp
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// The vector path, screened: a warp a row, rows blockIdx * 8 + warp, then
// the next gridDim * 8; a warp walks its row in tiles of 32 threads x C
// 16-byte loads, contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
gumbel_screen_kernel(const T* __restrict__ logits, const int* __restrict__ seed,
                     int* __restrict__ out, int rows, int v, int chunk, int k) {
  constexpr int VEC = 16 / sizeof(T), C = kLoads;  // lanes a load, loads a thread a tile
  using M = Max<T>;
  extern __shared__ float2 table[];
  build_table(table, k);
  __syncthreads();

  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr uint32_t hcut = 2u * kB0;  // a candidate's h
  const int fine = 32 - kCut - k;      // its bucket: 1 + ((h >> fine) & fmask)
  const uint32_t fmask = (1u << k) - 1u;
  const float2 g0 = table[0];  // every lane below the cut
  const int nchunks = v / VEC, ntiles = (nchunks + 32 * C - 1) / (32 * C);

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    float t_run = -INFINITY, bv = -INFINITY;
    int bi = INT_MAX;
    const uint32_t hbase = row_base(row, chunk, seed);
    const T* x = logits + static_cast<size_t>(row) * v;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    for (int tile = 0; tile < ntiles; ++tile) {
      Vec<T> d[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = (tile * C + c) * 32 + lane_id;
        if (j < nchunks) d[c] = xv[j];
      }
      // pass 1, every lane, without branches: the hash, the candidates'
      // mask and the largest logit (four chains, so that lanes overlap)
      M lm[4];
      uint32_t cand = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = (tile * C + c) * 32 + lane_id;
        const uint32_t h0 = hbase + static_cast<uint32_t>(j * VEC) * 40503u;
        if (j < nchunks) {
#pragma unroll
          for (int q = 0; q < VEC; q += M::kLanes)
            lm[(c * VEC + q) / M::kLanes & 3].add(&d[c].e[q]);
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            cand |= static_cast<uint32_t>(mix(h0 + q * 40503u) >= hcut) << (c * VEC + q);
        }
      }
      lm[0].merge(lm[1]);
      lm[2].merge(lm[3]);
      lm[0].merge(lm[2]);
      const float lmax = lm[0].value();
      // the lower bounds: below the cut fl(lmax + Glo[0]) bounds them all;
      // each candidate (about 4 in a warp's tile at V = 8192) takes its top
      // bucket's, its logit read again (the tile's lines, just loaded)
      float lo_max = __fadd_rn(lmax, g0.x);
      for (uint32_t m = cand; m; m &= m - 1) {
        const int e = __ffs(m) - 1;
        const int lane = ((tile * C + e / VEC) * 32 + lane_id) * VEC + e % VEC;
        const uint32_t h = mix(hbase + static_cast<uint32_t>(lane) * 40503u);
        lo_max = fmaxf(lo_max, __fadd_rn(to_f32(x[lane]), table[1 + ((h >> fine) & fmask)].x));
      }
      // the warp's running max of lo over its tiles of the row: a lower
      // bound of the row's maximum, so screening against it is exact
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lo_max = fmaxf(lo_max, __shfl_xor_sync(0xffffffffu, lo_max, off));
      t_run = fmaxf(t_run, lo_max);
      // pass 2: the candidates, and the lanes below the cut whose coarse
      // upper bound reaches T (none unless the thread's largest logit's
      // does; a NaN logit makes lmax NaN and is found here); each is held
      // to its bucket's upper bound, then takes the exact noise
      uint32_t live = cand;
      if (!(__fadd_rn(lmax, g0.y) < t_run)) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const bool in = (tile * C + c) * 32 + lane_id < nchunks;
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            live |= static_cast<uint32_t>(
                in && !(__fadd_rn(to_f32(d[c].e[q]), g0.y) < t_run)) << (c * VEC + q);
        }
      }
      while (live) {
        const int e = __ffs(live) - 1;
        live &= live - 1;
        const int lane = ((tile * C + e / VEC) * 32 + lane_id) * VEC + e % VEC;
        const uint32_t h = mix(hbase + static_cast<uint32_t>(lane) * 40503u);
        const float l = to_f32(x[lane]);
        const uint32_t b = h >= hcut ? 1 + ((h >> fine) & fmask) : fmask + 2 + (h >> (32 - k));
        const float2 gb = table[b];
        if (__fadd_rn(l, gb.y) < t_run) continue;
        const float val = __fadd_rn(l, noise(static_cast<int>(h >> 1)));
        if (better(val, lane, bv, bi)) {
          bv = val;
          bi = lane;
        }
      }
    }
    warp_best(bv, bi);
    if (lane_id == 0) out[row] = bi;
  }
}

// The rows the screen does not take (a ragged V, an unaligned row, a row
// shorter than a tile): a block of 256 threads a row, one element at a time,
// every lane exact (the earlier kernel's body).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gumbel_exact_kernel(const T* __restrict__ logits, const int* __restrict__ seed,
                    int* __restrict__ out, int v, int chunk) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int row = blockIdx.x;
  const uint32_t hbase = row_base(row, chunk, seed);
  const T* x = logits + static_cast<size_t>(row) * v;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int lane = threadIdx.x; lane < v; lane += kThreads) {
    const uint32_t h = mix(hbase + static_cast<uint32_t>(lane) * 40503u);
    const float val = __fadd_rn(to_f32(x[lane]), noise(static_cast<int>(h >> 1)));
    if (better(val, lane, bv, bi)) {
      bv = val;
      bi = lane;
    }
  }
  warp_best(bv, bi);
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  if (lane_id == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return;
  bv = lane_id < kWarps ? red_v[lane_id] : -INFINITY;
  bi = lane_id < kWarps ? red_i[lane_id] : INT_MAX;
  warp_best(bv, bi);
  if (lane_id == 0) out[row] = bi;
}

// Over all 2^31 bits: bad[0] counts bits whose noise is below its
// predecessor's (or NaN), bad[1] those outside either of their buckets'
// [Glo, Ghi] in the table of k. Each thread walks a contiguous range and
// compares across its start.
__global__ void __launch_bounds__(256)
bound_check_kernel(int k, unsigned long long* bad) {
  extern __shared__ float2 table[];
  build_table(table, k);
  __syncthreads();
  const uint32_t n = gridDim.x * blockDim.x;
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t per = (1u << 31) / n;  // n a power of two
  const uint32_t start = t * per;
  float prev = noise(static_cast<int>(start == 0 ? 0 : start - 1));
  unsigned long long mono = 0, outside = 0;
  for (uint32_t bits = start; bits < start + per; ++bits) {
    const float g = noise(static_cast<int>(bits));
    const float2 a = table[top_bucket(bits, k)], b = table[all_bucket(bits, k)];
    mono += !(prev <= g);
    outside += !(a.x <= g && g <= a.y && b.x <= g && g <= b.y);
    prev = g;
  }
  if (mono) atomicAdd(&bad[0], mono);
  if (outside) atomicAdd(&bad[1], outside);
}

size_t table_bytes(int k) { return sizeof(float2) * ((2u << k) + 1); }

template <typename T>
int launch(const void* logits, const void* seed, void* out, int rows, int v, int chunk, int k,
           int blocks, cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  const bool screen = v % vec == 0 && v >= 32 * kLoads * vec
                      && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  const T* x = static_cast<const T*>(logits);
  const int* s = static_cast<const int*>(seed);
  int* o = static_cast<int*>(out);
  if (screen)
    gumbel_screen_kernel<T><<<blocks, kThreads, table_bytes(k), stream>>>(x, s, o, rows, v,
                                                                          chunk, k);
  else
    gumbel_exact_kernel<T><<<rows, kThreads, 0, stream>>>(x, s, o, v, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// logits (rows, V) bf16 (is_bf16 = 1) or f32, contiguous on the device; seed
// (2,) int32 on the device; out (rows,) int32. rows >= 1, V >= 1, chunk >= 1;
// 2^k buckets (6 <= k <= 10); blocks >= 1 of 256 threads, each taking 8 rows
// at a time, a warp a row. Rows that are not screened (V not a multiple of a
// 16-byte load's lanes or below a tile, 1024 bf16 or 512 f32, or an unaligned
// row) take a block a row and no table, and ignore k and blocks once checked.
// Returns the cudaError_t of the launch.
int act_gumbel_argmax(const void* logits, const void* seed, void* out, int rows, int v,
                      int chunk, int is_bf16, int k, int blocks, void* stream) {
  if (k < kMinBits || k > kMaxBits || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(logits, seed, out, rows, v, chunk, k, blocks, st)
                 : launch<float>(logits, seed, out, rows, v, chunk, k, blocks, st);
}

// bad (2,) uint64 on the device, zeroed by the caller: see bound_check_kernel
int act_gumbel_bound_check(int k, void* bad, void* stream) {
  if (k < kMinBits || k > kMaxBits) return static_cast<int>(cudaErrorInvalidValue);
  bound_check_kernel<<<1024, 256, table_bytes(k), static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

const char* act_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
