// Fused WAN payload codec for Hopper (sm_90a): block-local top-k selection
// on a 16-bit truncated magnitude key plus per-block quantization (encode),
// and dequantize + scatter back to dense (decode).
//
// Replaces the Pallas TPU kernels of repro/kernels/wan_codec.py:
//   _encode_kernel (wrapper wan_encode_pallas) and
//   _decode_kernel (wrapper wan_decode_pallas).
// The bit-level spec is repro_torch/kernels/ref.py; these kernels reproduce
// it bit for bit (q, idx, scales and the decoded dense vector).
//
// Bound: both are memory-bound.  Encode must read every fp32 input once
// (n_rows * n * 4 bytes) and writes ~k/block of that; decode writes the
// dense fp32 output once and reads the small payload.
//
// Encode: one thread block of 256 threads per codec block, over all rows
// (pods) in one launch: grid (blocks per row, rows); the input row stride
// is a parameter, so a column slice of the (pods, N) sync buffer is read in
// place.
//   - blocks of up to 4096 values (the main path's 4096: 16 a thread) are
//     held in registers, loaded as a warp's 32 x 16 consecutive bytes
//     (float4 where the input is aligned), so a thread holds S / 4 groups
//     of 4 values and position order is (warp, group, lane, value);
//     larger blocks (up to 65536) keep the 16-bit keys in shared memory (2
//     bytes a value, 128 KB at 65536), a contiguous strip per thread;
//   - the key is bits(|x|) >> 15, a NaN's that of the canonical NaN (all
//     NaNs tie above +inf; the block maximum propagates NaN, so its scale
//     is then 1, as in the plain version).  A floor under the k_block-th
//     largest key t: each warp's c-th largest lane maximum, c =
//     ceil(k_block / 8) (by peeling the warp maximum off c times), since
//     the c largest lane maxima of all 8 warps are >= k_block distinct
//     values; the floor is the least of the 8.  A block whose floor equals
//     its largest key (all zero, all equal) has t at once;
//   - fast path (registers, <= 256 keys at or above the floor: ~2% of a
//     Gaussian block): one compare a value marks the candidates, one block
//     scan of their counts puts them, in index order, into a list in
//     shared memory (key, position and value), and warp 0 alone finishes:
//     two 8-bit histograms (high byte, then the low byte of the bin that
//     holds the k_block-th key) give t, a warp scan of the (above t, at t)
//     counts gives each tie its rank (ties to the lowest index) and each
//     winner its slot, and the winners are quantized.  3 barriers;
//   - general path (more candidates, k_block > 256, the shared-memory
//     blocks): the same two histograms over every value at or above the
//     floor, then one block scan of the per-group (above t, at t) counts,
//     packed as bit fields, and every thread quantizes its own winners.
// Rounding is pinned: build with -fmad=false and without fast math; the
// quotient is __fdiv_rn, the rounding rintf (half to even, like
// torch.round), the scale maxabs * INV with INV the float32 constant the
// caller passes, and fp8 goes through __nv_cvt_float_to_fp8 (round to
// nearest even, saturating) after clipping to +-448.
// -DKERNEL_SPLIT=1 (loads only) and 2 (no output writes) build the time
// split of tools/kernel_ab.py --split; the default 0 is the kernel.
//
// C interface (bound with ctypes); each launcher returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef KERNEL_SPLIT
#define KERNEL_SPLIT 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyShift = 15;        // key = bits(|x|) >> 15: bits 30..15
constexpr int kRegValues = 16;       // values per thread held in registers
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == 256, "one histogram bin per thread");

// max(a, b) with NaN propagated (PTX max.NaN; fmaxf drops a NaN): a NaN
// anywhere in a block makes its maximum the canonical NaN 0x7fffffff
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the key of a = |x|: bits 30..15, every NaN as the canonical NaN, so that
// a NaN ranks above +inf and all NaNs tie, as in the plain version
__device__ __forceinline__ unsigned key_of(float a) {
  return (a != a ? 0x7fffffffu : __float_as_uint(a)) >> kKeyShift;
}

// the c-th largest (1 <= c <= 32) of the warp's keys, equal keys counted
// apart: peel the largest key off at most c times
__device__ __forceinline__ unsigned warp_kth_key(unsigned key, int c) {
  int seen = 0;
  while (true) {
    const unsigned m = __reduce_max_sync(kFull, key);
    seen += __popc(__ballot_sync(kFull, key == m));
    if (seen >= c) return m;   // m == 0 ends it: every lane then counts
    if (key == m) key = 0;
  }
}

// The largest bin b of the 256-bin histogram h with h[b] + ... + h[255] >=
// target (1 <= target <= the sum of h); *above = h[b + 1] + ... + h[255].
// Every lane of the calling warp gets the answer.
__device__ __forceinline__ unsigned find_bin(const int* h, int target,
                                             int* above) {
  const int lane = threadIdx.x & 31;
  const int4 h0 = reinterpret_cast<const int4*>(h)[2 * lane];
  const int4 h1 = reinterpret_cast<const int4*>(h)[2 * lane + 1];
  const int c[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  int mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) mine += c[j];
  int suffix = mine;                   // this lane's bins and all above
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(kFull, suffix, o);
    if (lane + o < 32) suffix += y;
  }
  int run = suffix - mine, bin = -1, ab = 0;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    if (bin < 0 && run + c[j] >= target) {
      bin = 8 * lane + j;
      ab = run;
    }
    run += c[j];
  }
  // lower lanes find a bin too; the highest lane that does holds b
  const int src = 31 - __clz(__ballot_sync(kFull, bin >= 0));
  *above = __shfl_sync(kFull, ab, src);
  return (unsigned)__shfl_sync(kFull, bin, src);
}

// field c of NG packed counts of 32 / NG bits each
template <int NG>
__device__ __forceinline__ int field(unsigned v, int c) {
  if constexpr (NG == 1)
    return (int)v;
  else
    return (int)(v >> (32 / NG * c) & ((1u << 32 / NG) - 1));
}

// The exclusive prefix, in thread order, of two per-thread counts packed
// as NG fields of 32 / NG bits (field c: the count in group c), and the
// fields of the warp's totals; *total gets the block's two totals.
template <int NG>
__device__ __forceinline__ void block_scan2(unsigned a, unsigned b,
                                            int2* warp_tot, unsigned* ex,
                                            unsigned* wsum, int2* base,
                                            int2* total) {
  constexpr int kW = 32 / NG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned ya = __shfl_up_sync(kFull, ia, o);
    const unsigned yb = __shfl_up_sync(kFull, ib, o);
    if (lane >= o) {
      ia += ya;
      ib += yb;
    }
  }
  ex[0] = ia - a;
  ex[1] = ib - b;
  wsum[0] = __shfl_sync(kFull, ia, 31);
  wsum[1] = __shfl_sync(kFull, ib, 31);
  if (lane == 31) {
    int2 t = make_int2(0, 0);
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      t.x += field<NG>(ia, c);
      t.y += field<NG>(ib, c);
    }
    warp_tot[warp] = t;
  }
  __syncthreads();
  int2 pre = make_int2(0, 0), all = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int2 t = warp_tot[w];
    if (w < warp) {
      pre.x += t.x;
      pre.y += t.y;
    }
    all.x += t.x;
    all.y += t.y;
  }
  *base = pre;
  *total = all;
}

__device__ __forceinline__ int8_t quantize(float v, float scale, float qmax,
                                           bool fp8) {
  const float u = __fdiv_rn(v, scale);
  if (fp8) {
    const float c = fminf(fmaxf(u, -qmax), qmax);
    return (int8_t)__nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3);
  }
  const float r = fminf(fmaxf(rintf(u), -qmax), qmax);
  return (int8_t)(int)r;
}

// The selection of one warp over a list of c_list <= 256 candidates (key
// << 16 | position, and value), in index order, that holds the block's
// k_block largest keys: the k_block-th largest key t from two histograms
// (hist zeroed), the winners in index order, ties to the lowest index.
template <bool FP8>
__device__ __forceinline__ void select_from_list(
    const unsigned* list_word, const float* list_val, int c_list,
    int k_block, int (*hist)[256], float scale, float qmax,
    int8_t* __restrict__ q, int32_t* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  // lane l holds entries 8 l .. 8 l + 7
  const uint4 w0 = reinterpret_cast<const uint4*>(list_word)[2 * lane];
  const uint4 w1 = reinterpret_cast<const uint4*>(list_word)[2 * lane + 1];
  const unsigned w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const int n_mine = max(0, min(8, c_list - 8 * lane));
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < n_mine) atomicAdd(&hist[0][w[j] >> 24], 1);
  __syncwarp();
  int above_hi, above_lo;
  const unsigned hi = find_bin(hist[0], k_block, &above_hi);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < n_mine && w[j] >> 24 == hi)
      atomicAdd(&hist[1][w[j] >> 16 & 255], 1);
  __syncwarp();
  const unsigned t = hi << 8 | find_bin(hist[1], k_block - above_hi,
                                        &above_lo);
  int gt = 0, at = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    gt += j < n_mine && w[j] >> 16 > t;
    at += j < n_mine && w[j] >> 16 == t;
  }
  int igt = gt, iat = at;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int yg = __shfl_up_sync(kFull, igt, o);
    const int ya = __shfl_up_sync(kFull, iat, o);
    if (lane >= o) {
      igt += yg;
      iat += ya;
    }
  }
  const int need = k_block - __shfl_sync(kFull, igt, 31);
  int rank = iat - at;                 // of this lane's first tie
  int slot = igt - gt + min(rank, need);
  int chk = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned k = w[j] >> 16;
    bool take = j < n_mine && k > t;
    if (j < n_mine && k == t) take = rank++ < need;
    if (take) {
      const int8_t code = quantize(list_val[8 * lane + j], scale, qmax, FP8);
      if (KERNEL_SPLIT == 2) {
        chk += slot + code;
      } else {
        idx[slot] = (int)(w[j] & 0xffffu);
        q[slot] = code;
      }
      ++slot;
    }
  }
  if (KERNEL_SPLIT == 2 && chk == -1) q[0] = 1;
}

// S > 0: S values per thread in registers (blocks up to 256 * S values),
// VEC: loaded as float4; S == 0: the keys of any block up to 65536 values
// in dynamic shared memory, a contiguous strip per thread.
// 7 blocks an SM: 32 registers a thread and ~100 bytes of spill, which on
// an H100 ran the main path's encode faster than 6 blocks without spills
template <int S, bool VEC, bool FP8>
__global__ void __launch_bounds__(kThreads, 7)
encode_kernel(const float* __restrict__ x, long long row_stride, long long n,
              int block, int k_block, long long nb, float inv, float qmax,
              int8_t* __restrict__ q, int32_t* __restrict__ idx,
              float* __restrict__ scales) {
  // a thread's values: NG groups of G consecutive positions; group c of
  // lane l in warp w starts at 32 S w + 32 G c + G l, so a warp loads a
  // group as 32 G consecutive values, and position order is (warp, group,
  // lane, value)
  constexpr int G = S >= 4 ? 4 : (S > 0 ? S : 1);
  constexpr int NG = S > 0 ? S / G : 1;
  extern __shared__ uint16_t block_keys[];
  __shared__ __align__(16) int hist[2][256];
  __shared__ __align__(16) unsigned list_word[kThreads];
  __shared__ float list_val[kThreads];
  __shared__ unsigned warp_max[kWarps], warp_floor[kWarps];
  __shared__ int2 warp_tot[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long row = blockIdx.y;
  const float* xb = x + row * row_stride + b * block;
  const long long left = n - b * block;
  const int valid = left < block ? (int)left : block;   // ragged last block
  // S == 0: this thread's strip [lo, lo + len); positions past valid read 0
  const int per = (block + kThreads - 1) / kThreads;
  const int lo = tid * per;
  const int len = max(0, min(per, block - lo));
  const int wbase = 32 * S * warp + G * lane;   // S > 0: group 0's start

  hist[0][tid] = 0;
  hist[1][tid] = 0;

  float v[S > 0 ? S : 1];
  float mx = 0.0f;                     // largest |x| this thread read
  if constexpr (S > 0) {
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      const int p = wbase + 32 * G * c;
      if constexpr (VEC) {
        static_assert(G == 4, "16-byte loads take groups of 4");
        if (p + 3 < valid) {
          const float4 f = *reinterpret_cast<const float4*>(xb + p);
          v[G * c] = f.x;
          v[G * c + 1] = f.y;
          v[G * c + 2] = f.z;
          v[G * c + 3] = f.w;
          continue;
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i)
        v[G * c + i] = p + i < valid ? xb[p + i] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) mx = fmax_nan(mx, fabsf(v[i]));
  } else {
    for (int j = tid; j < block; j += kThreads) {  // coalesced
      const float a = j < valid ? fabsf(xb[j]) : 0.0f;
      mx = fmax_nan(mx, a);
      block_keys[j] = (uint16_t)key_of(a);
    }
  }
  if (KERNEL_SPLIT == 1) {
    if (__float_as_uint(mx) == kFull) q[0] = 1;
    return;
  }

  // f(group, register index, position) for each value of this thread
  auto for_values = [&](auto f) {
    if constexpr (S > 0) {
#pragma unroll
      for (int c = 0; c < NG; ++c)
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int p = wbase + 32 * G * c + i;
          if (p < block) f(c, G * c + i, p);
        }
    } else {
      for (int i = 0; i < len; ++i) f(0, 0, lo + i);
    }
  };
  auto key = [&](int r, int p) -> unsigned {
    if constexpr (S > 0)
      return key_of(fabsf(v[r]));
    else
      return block_keys[p];
  };
  auto val = [&](int r, int p) -> float {
    if constexpr (S > 0)
      return v[r];
    else
      return p < valid ? xb[p] : 0.0f;
  };

  // the floor: each warp's c-th largest lane maximum (a thread's values
  // are its own, so lane maxima are distinct values of the block)
  const int c_floor = (k_block + kWarps - 1) / kWarps;
  const unsigned mbits = __float_as_uint(mx);
  const unsigned wmax = __reduce_max_sync(kFull, mbits);
  const unsigned wfloor =
      c_floor <= 32 ? warp_kth_key(mbits >> kKeyShift, c_floor) : 0u;
  if (lane == 0) {
    warp_max[warp] = wmax;
    warp_floor[warp] = wfloor;
  }
  __syncthreads();
  unsigned maxbits = 0, floor_key = 0xffffu;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    maxbits = max(maxbits, warp_max[w]);
    floor_key = min(floor_key, warp_floor[w]);
  }
  const unsigned top = maxbits >> kKeyShift;
  const float maxabs = __uint_as_float(maxbits);
  const float scale = maxabs > 0.0f ? maxabs * inv : 1.0f;
  const long long out = (row * nb + b) * k_block;

  if constexpr (S > 0) {
    if (floor_key < top) {
      // the candidates (key >= floor), in index order, into the list; a
      // floor below top is a number or +inf, which a NaN's key is above
      const float floor_val = __uint_as_float(floor_key << kKeyShift);
      unsigned mask = 0, cnt = 0;
#pragma unroll
      for (int r = 0; r < S; ++r)
        mask |= (unsigned)!(fabsf(v[r]) < floor_val) << r;
      if (floor_key == 0) {            // a pad past the block is no value
#pragma unroll
        for (int r = 0; r < S; ++r)
          if (wbase + 32 * G * (r / G) + r % G >= block) mask &= ~(1u << r);
      }
#pragma unroll
      for (int c = 0; c < NG; ++c)
        cnt += (unsigned)__popc(mask >> G * c & ((1u << G) - 1))
               << (32 / NG * c);
      unsigned ex[2], wsum[2];
      int2 base, total;
      block_scan2<NG>(cnt, 0u, warp_tot, ex, wsum, &base, &total);
      if (total.x <= kThreads) {
#pragma unroll
        for (int c = 0; c < NG; ++c) {
          int off = base.x + field<NG>(ex[0], c);
          base.x += field<NG>(wsum[0], c);
          unsigned m = mask >> G * c & ((1u << G) - 1);
          while (m) {
            const int i = __ffs(m) - 1;
            m &= m - 1;
            const int p = wbase + 32 * G * c + i;
            const float xv = p < valid ? xb[p] : 0.0f;   // cached: just read
            list_word[off] = key_of(fabsf(xv)) << 16 | p;
            list_val[off] = xv;
            ++off;
          }
        }
        __syncthreads();
        if (warp == 0)
          select_from_list<FP8>(list_word, list_val, total.x, k_block, hist,
                                scale, qmax, q + out, idx + out);
        if (tid == 0) scales[row * nb + b] = scale;
        return;
      }
    }
  }

  // general path: every value takes part in each pass
  unsigned t = top;                    // t: the k_block-th largest key
  if (floor_key < top) {
    for_values([&](int, int r, int p) {
      const unsigned k = key(r, p);
      if (k >= floor_key) atomicAdd(&hist[0][k >> 8], 1);
    });
    __syncthreads();
    int above_hi, above_lo;
    const unsigned hi = find_bin(hist[0], k_block, &above_hi);
    for_values([&](int, int r, int p) {
      const unsigned k = key(r, p);
      if (k >= floor_key && k >> 8 == hi) atomicAdd(&hist[1][k & 255], 1);
    });
    __syncthreads();
    t = hi << 8 | find_bin(hist[1], k_block - above_hi, &above_lo);
  }

  // counts above and at t per group, then each group's first slot
  unsigned above = 0, at = 0;
  for_values([&](int c, int r, int p) {
    const unsigned k = key(r, p);
    above += (unsigned)(k > t) << (32 / NG * c);
    at += (unsigned)(k == t) << (32 / NG * c);
  });
  unsigned ex[2], wsum[2];
  int2 base, total;
  block_scan2<NG>(above, at, warp_tot, ex, wsum, &base, &total);
  const int need = k_block - total.x;  // ties to take, lowest index first
  int slot[NG], rank[NG];              // next slot, rank of the next tie
#pragma unroll
  for (int c = 0; c < NG; ++c) {
    const int pa = base.x + field<NG>(ex[0], c);
    const int pt = base.y + field<NG>(ex[1], c);
    slot[c] = pa + min(pt, need);
    rank[c] = pt;
    base.x += field<NG>(wsum[0], c);   // the warp's earlier groups
    base.y += field<NG>(wsum[1], c);
  }

  int chk = 0;
  for_values([&](int c, int r, int p) {
    const unsigned k = key(r, p);
    bool take = k > t;
    if (k == t) take = rank[c]++ < need;
    if (take) {
      const int8_t code = quantize(val(r, p), scale, qmax, FP8);
      if (KERNEL_SPLIT == 2) {
        chk += slot[c] + code;
      } else {
        idx[out + slot[c]] = p;
        q[out + slot[c]] = code;
      }
      ++slot[c];
    }
  });
  if (KERNEL_SPLIT == 2 && chk == -1) q[out] = 1;
  if (tid == 0) scales[row * nb + b] = scale;
}

template <bool FP8>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const int8_t* __restrict__ q, const int32_t* __restrict__ idx,
              const float* __restrict__ scales, long long n, int block,
              int k_block, long long nb, float* __restrict__ out) {
  const long long b = blockIdx.x;
  const long long row = blockIdx.y;
  float* ob = out + row * n + b * block;
  const long long left = n - b * block;
  const int valid = left < block ? (int)left : block;

  for (int j = threadIdx.x; j < valid; j += kThreads) ob[j] = 0.0f;
  __syncthreads();

  const float s = scales[row * nb + b];
  const long long base = (row * nb + b) * k_block;
  for (int j = threadIdx.x; j < k_block; j += kThreads) {
    const int i = idx[base + j];
    if ((unsigned)i >= (unsigned)valid) continue;   // padding slots
    float c;
    if (FP8) {
      const __half_raw h = __nv_cvt_fp8_to_halfraw(
          (__nv_fp8_storage_t)(uint8_t)q[base + j], __NV_E4M3);
      c = __half2float(__half(h));
    } else {
      c = (float)q[base + j];
    }
    ob[i] = c * s;
  }
}

constexpr size_t kDefaultSmem = 48 * 1024;

template <int S, bool VEC, bool FP8>
int launch_encode(const float* x, long long row_stride, long long n,
                  int rows, int block, int k_block, float inv, float qmax,
                  int8_t* q, int32_t* idx, float* scales, cudaStream_t s) {
  const long long nb = (n + block - 1) / block;
  const size_t smem = S > 0 ? 0 : (size_t)block * sizeof(uint16_t);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_kernel<S, VEC, FP8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  encode_kernel<S, VEC, FP8><<<dim3((unsigned)nb, (unsigned)rows), kThreads,
                               smem, s>>>(x, row_stride, n, block, k_block,
                                          nb, inv, qmax, q, idx, scales);
  return (int)cudaGetLastError();
}

template <bool FP8>
int dispatch_encode(const float* x, long long row_stride, long long n,
                    int rows, int block, int k_block, float inv, float qmax,
                    int8_t* q, int32_t* idx, float* scales, cudaStream_t s) {
  // 16-byte loads: an aligned base, row stride and block
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   row_stride % 4 == 0 && block % 4 == 0;
#define ENCODE_CASE(S, VEC)                                                  \
  return launch_encode<S, VEC, FP8>(x, row_stride, n, rows, block, k_block, \
                                    inv, qmax, q, idx, scales, s)
  if (block <= kThreads) ENCODE_CASE(1, false);
  if (block <= 2 * kThreads) ENCODE_CASE(2, false);
  if (block <= 4 * kThreads) {
    if (vec) ENCODE_CASE(4, true);
    ENCODE_CASE(4, false);
  }
  if (block <= 8 * kThreads) {
    if (vec) ENCODE_CASE(8, true);
    ENCODE_CASE(8, false);
  }
  if (block <= kRegValues * kThreads) {
    if (vec) ENCODE_CASE(kRegValues, true);
    ENCODE_CASE(kRegValues, false);
  }
  ENCODE_CASE(0, false);
#undef ENCODE_CASE
}

}  // namespace

extern "C" int wan_encode_launch(const float* x, long long row_stride,
                                 long long n, int rows, int block,
                                 int k_block, int fp8, float inv, float qmax,
                                 int8_t* q, int32_t* idx, float* scales,
                                 void* stream) {
  if (block < 1 || block > 65536 || k_block < 1 || k_block > block)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (fp8)
    return dispatch_encode<true>(x, row_stride, n, rows, block, k_block, inv,
                                 qmax, q, idx, scales, s);
  return dispatch_encode<false>(x, row_stride, n, rows, block, k_block, inv,
                                qmax, q, idx, scales, s);
}

extern "C" int wan_decode_launch(const int8_t* q, const int32_t* idx,
                                 const float* scales, long long n, int rows,
                                 int block, int k_block, int fp8, float* out,
                                 void* stream) {
  const long long nb = (n + block - 1) / block;
  const dim3 grid((unsigned)nb, (unsigned)rows);
  cudaStream_t s = (cudaStream_t)stream;
  if (fp8)
    decode_kernel<true><<<grid, kThreads, 0, s>>>(q, idx, scales, n, block,
                                                  k_block, nb, out);
  else
    decode_kernel<false><<<grid, kThreads, 0, s>>>(q, idx, scales, n, block,
                                                   k_block, nb, out);
  return (int)cudaGetLastError();
}

extern "C" const char* wan_codec_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
