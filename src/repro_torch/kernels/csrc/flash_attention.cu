// Blockwise flash attention (forward) for Hopper (sm_90a): causal, sliding
// window, tanh soft-capping and GQA, with an online softmax.
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention.py:
//   _kernel (wrapper flash_attention).
// The spec is repro_torch/kernels/ref.py::sdpa (the full softmax over masks
// built from positions 0..S-1); this kernel agrees with it to about one
// bf16 ulp (bf16 inputs) or f32 rounding (f32 inputs), not to the bit: the
// online softmax rescales partial sums in another order.
//
// Bound: operations.  At the serving prefill's shape (S 2048, 32 heads,
// Dh 128) the causal products are ~34 GFLOP against ~25 MB of q, k, v and
// o, far above the card's ~295 FLOP/byte balance point: the products have
// to run on the tensor cores.
//
// bf16 inputs (the serving path): flash_mma_kernel, FlashAttention-2's
// shape on mma.sync.
//   - one thread block of 4 warps per (q-tile, head, batch row); each warp
//     owns 32 query rows as two 16-row m-tiles (128 rows a block; one
//     m-tile and 64 rows at Dh 256, where the O accumulator alone takes 128
//     registers a thread), so each K or V fragment read from shared memory
//     feeds two products; a loop over k-tiles of 64 keys replaces the
//     TPU's sequential last grid axis;
//   - q, k and v are staged in shared memory in bf16 with cp.async (16
//     bytes a thread, zero-filled past the ragged edge), rows skewed by 16
//     bytes so that ldmatrix's eight row reads hit eight bank groups; K and
//     V are double-buffered, so tile t+1 loads while tile t computes, with
//     one barrier a tile; Q's fragments are re-read by ldmatrix at each
//     k-step, which keeps registers for the accumulators (no spills);
//   - S = Q K^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate: the product
//     of two bf16 values is exact in f32, so this is the spec's f32
//     arithmetic summed in another order);
//   - the online softmax runs on the accumulator fragments in the log2
//     domain: the row max is taken on the raw scores (a quad __shfl_xor)
//     and scale * log2 e is folded into one FMA a score before the
//     hardware exp2 (ex2.approx); soft-capping is one uniform branch a
//     tile, not a select per score; a row's sum stays per thread until
//     the end;
//   - P = exp2(S - m) is rounded to bf16 in registers, where the S
//     accumulator layout is already the A fragment of P V, a second
//     mma.sync; l sums the rounded P, so the output is a convex combination
//     of V's rows.  The TPU kernel keeps P in f32; rounding it moves the
//     output by about one bf16 ulp, within the 2e-2 tolerance;
//   - masks are evaluated only on tiles that cross the diagonal, the
//     window's edge or the end of k; the TPU kernel's block-level causal and
//     window skips stay (as the k loop's bounds), and a warp skips the
//     tiles that are masked for all its rows (a skip by 16-key steps inside
//     a tile would cut the unrolled products into basic blocks that the
//     compiler cannot schedule across, which costs more than it saves);
//   - q-tiles are scheduled longest first across all heads (the q-tile is
//     the grid's slowest axis and runs backwards), so the short causal
//     tiles fill the tail;
//   - q, k and v are read in place through their strides; the wrapper
//     refuses a base or a stride that is not 16-byte aligned.
// Shared memory: 2 (BQ + 4 * 64) (Dh + 8) bytes: 102 KB at Dh 128, 165 KB
// at Dh 256 (above 48 KB through cudaFuncSetAttribute); two blocks of 4
// warps share an SM at Dh 128.
//
// f32 inputs (on no main path): flash_f32_kernel, the scalar design of the
// first port, unchanged: 64-row q-tiles, 32-key k-tiles, f32 tiles in
// shared memory and explicit fmaf products.
//
// C interface (bound with ctypes); the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, sk, group, window;            // window <= 0: none
  int causal;
  float scale, softcap;                 // softcap <= 0: none
  long long qs[3], ks[3], vs[3], os[3]; // (batch, seq, head) strides
};

// ------------------------------------------------------------ bf16 path

// 2^x by the hardware's approximation (about 2 ulp; a result below f32's
// normal range flushes to 0, and 2^-inf = 0): P is rounded to bf16 next
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kBK = 64;                 // keys per k-tile (bf16 path)

template <int DH>
struct MmaTile {
  static constexpr int kWarps = 4;
  static constexpr int kMT = DH > 128 ? 1 : 2;  // 16-row m-tiles a warp
  static constexpr int kBQ = 16 * kMT * kWarps; // query rows per block
  static constexpr int kLd = DH + 8;            // skewed row, in elements
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (size_t)(kBQ + 4 * kBK) * kLd;
};

// rows [row0, row0 + rows) of a (seq, DH) bf16 view with row stride rs into
// dst[rows][DH + 8]; rows at or past n are zero-filled
template <int DH, int NT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long rs, int row0, int rows,
                                           int n) {
  constexpr int kChunks = DH / 8;               // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks, s = row0 + r;
    const bool ok = s < n;
    tc::cp_async16(dst + r * (DH + 8) + c * 8,
                   ok ? src + (long long)s * rs + c * 8 : src, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(MmaTile<DH>::kWarps * 32)
flash_mma_kernel(const Args a) {
  using T = MmaTile<DH>;
  constexpr int kNT = T::kWarps * 32, kBQ = T::kBQ, kLd = T::kLd;
  constexpr int kMT = T::kMT, kWR = 16 * kMT;   // m-tiles, rows a warp
  constexpr int kSN = kBK / 8;                  // S n-tiles (8 keys each)
  constexpr int kON = DH / 8;                   // O n-tiles (8 dims each)
  constexpr int kDK = DH / 16;                  // k-steps of Q K^T
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ks = qs + kBQ * kLd;           // [2][kBK][kLd]
  __nv_bfloat16* vs = ks + 2 * kBK * kLd;       // [2][kBK][kLd]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;      // ldmatrix: matrix, row
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest first
  const int row0 = q0 + kWR * warp;             // the warp's first row
  const int kh = h / a.group;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.qs[0] + h * a.qs[2];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.ks[0] + kh * a.ks[2];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.vs[0] + kh * a.vs[2];

  // the visible k-tiles, by the TPU kernel's block-level skips
  int kt_end = (a.sk + kBK - 1) / kBK;
  if (a.causal) kt_end = min(kt_end, (min(q0 + kBQ, a.sq) - 1) / kBK + 1);
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / kBK : 0;

  stage_rows<DH, kNT>(qs, qg, a.qs[1], q0, kBQ, a.sq);
  if (kt_begin < kt_end) {
    stage_rows<DH, kNT>(ks, kg, a.ks[1], kt_begin * kBK, kBK, a.sk);
    stage_rows<DH, kNT>(vs, vg, a.vs[1], kt_begin * kBK, kBK, a.sk);
  }
  tc::cp_async_commit();

  float o[kMT][kON][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < kON; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = -INFINITY;
      l[mt][i] = 0.f;
    }
  }
  // the warp's Q rows, re-read from shared memory by ldmatrix each k-tile
  const __nv_bfloat16* qrow = qs + (kWR * warp + (lane & 15)) * kLd +
                              (lane >> 4) * 8;
  const float sl2 = a.scale * kLog2e;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();          // tile kt has landed; tile kt-1 is consumed
    if (kt + 1 < kt_end) {
      stage_rows<DH, kNT>(ks + (st ^ 1) * kBK * kLd, kg, a.ks[1],
                          (kt + 1) * kBK, kBK, a.sk);
      stage_rows<DH, kNT>(vs + (st ^ 1) * kBK * kLd, vg, a.vs[1],
                          (kt + 1) * kBK, kBK, a.sk);
    }
    tc::cp_async_commit();

    const int k0 = kt * kBK;
    // the tile is masked for every row of this warp
    if (a.causal && k0 > row0 + kWR - 1) continue;
    if (a.window > 0 && k0 + kBK - 1 <= row0 - a.window) continue;

    // ---- S = Q K^T
    const __nv_bfloat16* kst = ks + st * kBK * kLd;
    float s[kMT][kSN][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kSN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        tc::ldmatrix_x4(af[mt], qrow + 16 * mt * kLd + 16 * kk);
#pragma unroll
      for (int jj = 0; jj < kBK / 16; ++jj) {
        uint32_t bf[4];   // keys 16jj + (0..7 | 8..15), dims (0..7 | 8..15)
        tc::ldmatrix_x4(bf, kst + (16 * jj + lr + (lm >> 1) * 8) * kLd +
                                16 * kk + (lm & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          tc::mma_bf16(s[mt][2 * jj], af[mt], bf[0], bf[1]);
          tc::mma_bf16(s[mt][2 * jj + 1], af[mt], bf[2], bf[3]);
        }
      }
    }

    // ---- soft-cap, one uniform branch for the tile; without it the scale
    // (times log2 e) is folded into the exponent below, one FMA a score
    float mul = sl2;
    if (a.softcap > 0.f) {
      const float inv_cap = a.scale / a.softcap, cap2 = a.softcap * kLog2e;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kSN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] = cap2 * tanhf(s[mt][j][e] * inv_cap);
      mul = 1.f;
    }
    // ---- masks, only on a tile that crosses the diagonal, the window's
    // edge or the end of k
    if (k0 + kBK > a.sk || (a.causal && k0 + kBK - 1 > row0) ||
        (a.window > 0 && k0 <= row0 + kWR - 1 - a.window)) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kSN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = row0 + 16 * mt + g + 8 * (e >> 1);
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            if (!(kp < a.sk && (!a.causal || kp <= qp) &&
                  (a.window <= 0 || kp > qp - a.window)))
              s[mt][j][e] = -INFINITY;
          }
    }

    // ---- online softmax: row max by quad shuffles, exp2, P in bf16
    uint32_t p[kMT][kSN][2];  // rows g and g + 8 of each m-tile
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSN; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * i], s[mt][j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][i], mx * mul);    // log2 domain
        const float mu = m_new == -INFINITY ? 0.f : m_new;  // nothing yet
        const float alpha = fast_exp2(m[mt][i] - mu);
        m[mt][i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kSN; ++j) {
          p[mt][j][i] = tc::pack_bf16(
              fast_exp2(fmaf(s[mt][j][2 * i], mul, -mu)),
              fast_exp2(fmaf(s[mt][j][2 * i + 1], mul, -mu)));
          const __nv_bfloat162 pb =
              *reinterpret_cast<const __nv_bfloat162*>(&p[mt][j][i]);
          sum += __low2float(pb) + __high2float(pb);
        }
        l[mt][i] = l[mt][i] * alpha + sum;
#pragma unroll
        for (int n = 0; n < kON; ++n) {
          o[mt][n][2 * i] *= alpha;
          o[mt][n][2 * i + 1] *= alpha;
        }
      }
    }

    // ---- O += P V
    const __nv_bfloat16* vst = vs + st * kBK * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < kON / 2; ++nn) {
        uint32_t bf[4];   // keys 16kk + (0..7 | 8..15), dims 16nn + (0 | 8)
        tc::ldmatrix_x4_trans(bf, vst + (16 * kk + lr + (lm & 1) * 8) * kLd +
                                      16 * nn + (lm >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const uint32_t af[4] = {p[mt][2 * kk][0], p[mt][2 * kk][1],
                                  p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]};
          tc::mma_bf16(o[mt][2 * nn], af, bf[0], bf[1]);
          tc::mma_bf16(o[mt][2 * nn + 1], af, bf[2], bf[3]);
        }
      }
    }
  }

  // ---- normalise and write; a row that saw no key writes zeros
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] +
                      h * a.os[2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = li > 0.f ? 1.f / li : 0.f;
      const int qp = row0 + 16 * mt + g + 8 * i;
      if (qp >= a.sq) continue;
      __nv_bfloat16* orow = og + qp * a.os[1] + 2 * t;
#pragma unroll
      for (int n = 0; n < kON; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = tc::pack_bf16(
            o[mt][n][2 * i] * inv, o[mt][n][2 * i + 1] * inv);
    }
}

template <int DH>
int launch_mma(const Args& a, int batch, int heads, cudaStream_t stream) {
  using T = MmaTile<DH>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_qt = (a.sq + T::kBQ - 1) / T::kBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)heads, (unsigned)batch, (unsigned)n_qt);
  flash_mma_kernel<DH><<<grid, T::kWarps * 32, T::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- f32 path

constexpr int kF32BQ = 64;              // query rows per block
constexpr int kF32BK = 32;              // keys per k-tile
constexpr int kF32Threads = 256;        // 16 x 16 threads
constexpr int kPadQ = kF32BQ + 4;       // row stride of the transposed q, p
constexpr int kPadK = kF32BK + 4;       // row stride of the transposed k
constexpr int kRows = kF32BQ / 16;      // query rows per thread (4)
constexpr int kCols = kF32BK / 16;      // score columns per thread (2)

static_assert(kRows == 4 && kCols == 2, "vector loads assume a 4 x 2 block");

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// one block per (q-tile, head, batch row); tiles staged as f32 (q and k
// transposed, so the score product reads 4 q rows and 2 keys per vector
// load); each thread owns a 4 x 2 block of scores and a 4 x Dh/16 block of
// the output
template <int DH>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const Args a) {
  constexpr int kDN = DH / 16;                // output columns per thread
  constexpr int kVec = kDN < 4 ? kDN : 4;     // width of a V vector load
  constexpr int kNV = kDN / kVec;             // V vector loads per key
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [DH][kPadQ] q, transposed
  float* ks = qs + DH * kPadQ;                  // [DH][kPadK] k, transposed
  float* vs = ks + DH * kPadK;                  // [kF32BK][DH] v
  float* ps = vs + kF32BK * DH;                 // [kF32BK][kPadQ] p, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;    // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kF32BQ;
  const float* qg = static_cast<const float*>(a.q) + b * a.qs[0] +
                    h * a.qs[2];
  const float* kg = static_cast<const float*>(a.k) + b * a.ks[0] +
                    (h / a.group) * a.ks[2];
  const float* vg = static_cast<const float*>(a.v) + b * a.vs[0] +
                    (h / a.group) * a.vs[2];

  for (int i = tid; i < kF32BQ * DH; i += kF32Threads) {
    const int r = i / DH, d = i % DH, s = q0 + r;
    qs[d * kPadQ + r] = s < a.sq ? qg[s * a.qs[1] + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDN];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDN; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (a.sk + kF32BK - 1) / kF32BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kF32BK;
    // block-level skip, as the TPU kernel: is any (q, k) pair visible?
    if (a.causal && k0 > q0 + kF32BQ - 1) continue;
    if (a.window > 0 && k0 + kF32BK - 1 <= q0 - a.window) continue;

    __syncthreads();              // the previous tile's readers are done
    for (int i = tid; i < kF32BK * DH; i += kF32Threads) {
      const int r = i / DH, d = i % DH, s = k0 + r;
      const bool in = s < a.sk;
      ks[d * kPadK + r] = in ? kg[s * a.ks[1] + d] : 0.f;
      vs[r * DH + d] = in ? vg[s * a.vs[1] + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[d * kPadQ +
                                                            ty * kRows]);
      const float2 kv = *reinterpret_cast<const float2*>(&ks[d * kPadK +
                                                            tx * kCols]);
      const float qr[kRows] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        s[i][0] = fmaf(qr[i], kv.x, s[i][0]);
        s[i][1] = fmaf(qr[i], kv.y, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx * kCols + j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        ok[j] = kp < a.sk && qp < a.sq && (!a.causal || kp <= qp) &&
                (a.window <= 0 || kp > qp - a.window);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        ps[(tx * kCols + j) * kPadQ + ty * kRows + i] = p;
        psum += p;
      }
      const float alpha = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - m_safe);
      l[i] = alpha * l[i] + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDN; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&ps[kk * kPadQ +
                                                            ty * kRows]);
      const float pr[kRows] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int jj = 0; jj < kNV; ++jj) {
        const float* vp = &vs[kk * DH + tx * kVec + 16 * kVec * jj];
        float vr[kVec];
        if constexpr (kVec == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vp);
          vr[0] = t4.x; vr[1] = t4.y; vr[2] = t4.z; vr[3] = t4.w;
        } else {
          const float2 t2 = *reinterpret_cast<const float2*>(vp);
          vr[0] = t2.x; vr[1] = t2.y;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[i][jj * kVec + e] = fmaf(pr[i], vr[e], acc[i][jj * kVec + e]);
      }
    }
  }

  float* og = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[2];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= a.sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int jj = 0; jj < kNV; ++jj)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        og[qp * a.os[1] + tx * kVec + 16 * kVec * jj + e] =
            acc[i][jj * kVec + e] * inv;
  }
}

template <int DH>
int launch_f32(const Args& a, int batch, int heads, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (size_t)(DH * kPadQ + DH * kPadK + kF32BK * DH +
                               kF32BK * kPadQ);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)((a.sq + kF32BQ - 1) / kF32BQ), (unsigned)heads,
                  (unsigned)batch);
  flash_f32_kernel<DH><<<grid, kF32Threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(const Args& a, bool bf16, int batch, int heads,
           cudaStream_t stream) {
  return bf16 ? launch_mma<DH>(a, batch, heads, stream)
              : launch_f32<DH>(a, batch, heads, stream);
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) of q, k, v, then o; the
// last dimension of each is contiguous.  bf16 != 0: all four are bf16
// (every base and stride 16-byte aligned), else f32.  window <= 0: no
// window; softcap <= 0: no soft-capping.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bf16,
                                      int batch, int sq, int sk, int heads,
                                      int kv_heads, int dh,
                                      const long long* strides, int causal,
                                      int window, float softcap, float scale,
                                      void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.sq = sq; a.sk = sk; a.group = heads / kv_heads;
  a.window = window; a.causal = causal;
  a.scale = scale; a.softcap = softcap;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 32: return launch<32>(a, bf16 != 0, batch, heads, s);
    case 64: return launch<64>(a, bf16 != 0, batch, heads, s);
    case 128: return launch<128>(a, bf16 != 0, batch, heads, s);
    case 256: return launch<256>(a, bf16 != 0, batch, heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bf16 tile at Dh <= 128, for the host side's constants: axis 0 ->
// query rows per block, 1 -> keys per k-tile
extern "C" int flash_attention_tile(int axis) {
  return axis == 0 ? MmaTile<128>::kBQ : kBK;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
