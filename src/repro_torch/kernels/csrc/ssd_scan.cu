// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/ssd_scan.py:
//   _kernel (wrapper ssd_scan).
// The spec is repro_torch/kernels/ref.py::ssd (the chunked algorithm of
// models/ssm.py::ssd_chunked, all in f32).  Per (batch row b, head h) and
// per chunk of L steps, with a_cum = cumsum(a) over the chunk:
//   y     = ((C B^T) o tril exp(a_cum[i] - a_cum[j])) x     intra-chunk
//         + (C state^T) * exp(a_cum)                       carried state
//   state = state * exp(a_cum[L-1]) + x^T (B * exp(a_cum[L-1] - a_cum))
// where y uses the state that enters the chunk.  The kernel agrees with the
// spec to f32 rounding, not to the bit: sums run in another order, and the
// log-decay prefix is kept in f64 (below).
//
// Bound: operations.  At the serving prefill's shape (S 2048, 64 heads,
// P 64, N 128, L 256) the useful work is ~10.8 GFLOP per launch: 4.3 of
// C B^T, whose operands are bf16 there, and 6.5 of products with an f32
// operand, against ~70 MB of x, y, B, C and the states.  Design:
//   - no sequential grid axis: one thread block owns one (P-tile, head,
//     batch row) and loops over the chunks itself; the (N, P-tile) f32
//     state stays in shared memory from the first chunk to the last;
//   - a chunk is worked in 64-row sub-tiles, since whole f32 B and C chunks
//     (128 KB each at L 256, N 128) do not fit beside each other: for each
//     i-tile the carried-state term goes first into a 64 x P-tile register
//     accumulator, then each j-tile <= i-tile (the causal skip) adds its
//     masked scores times x; the last i-tile, whose j-tiles cover the whole
//     chunk, also accumulates the state update in registers, and the new
//     state is written only after every i-tile has read the incoming one;
//   - the cumulative log decay of the chunk is one warp scan in f64, kept
//     in shared memory, and a_cum[i] - a_cum[j] is taken in f64 before its
//     exp: at the model's real decays (|a| up to a few hundred per step in
//     the fast heads) a_cum reaches ~1e4, where one f32 ulp (~1e-3) would
//     already move exp(a_cum[i] - a_cum[j]) by 1e-3; exp is taken only where j <= i, and
//     0 is written above the diagonal without evaluating it, as the
//     reference's `where`; below the diagonal tile the decay factors into
//     one exp per row and one per column (exp(a_cum[i] - a_cum[i0]) *
//     exp(a_cum[i0] - a_cum[j]), both <= 1 for a decay a <= 0), so only the
//     diagonal tiles take an exp per score;
//   - B and C sub-tiles stay in shared memory row-major in their own type
//     (bf16 on the serving path: half the bytes of f32);
//   - C B^T: with bf16 B and C the product of two bf16 values is exact in
//     f32, so it runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate: the f32 spec's arithmetic, summed in another order); with
//     f32 B and C it runs as scalar f32 FMAs, each thread owning a 4 x 4
//     block of scores;
//   - the products with f32 operands (the masked scores times x, the
//     carried-state term and the state update) run as scalar f32 FMAs:
//     each thread owns a 4 x P-tile/16 block of y and a P-tile/16 x 8 block
//     of the state, and every shared-memory load feeds 2-8 FMAs;
//   - parallelism: B*H blocks (64 at the prefill shape) are fewer than the
//     card's block slots, so the P axis is halved (recomputing the scores
//     per P-tile, cheap on the tensor cores) while twice the blocks still
//     fit in one wave at the occupancy the smaller tile allows;
//   - x, a, B and C are read in place through their strides: B and C may be
//     a stride-0 view over heads (one B/C group), so no repeated copy is
//     made; a tile's loads are all issued before its first store.
// Explicit fmaf throughout: the build passes -fmad=false for the codec's
// sake.  wgmma and TMA are the next step for speed.  Shared memory per
// block: 4 * (Np*Pt + 64*Pt + 64*68 + 3*64) + 8 * L bytes plus two 64-row
// B/C tiles of Np + 8 (bf16) or Np + 4 (f32) elements a row, Np = N
// rounded up to 16: 78 KB at N 128, P-tile 32, L 256 with bf16 B and C.
//
// C interface (bound with ctypes); the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kT = 64;                  // rows of a chunk sub-tile
constexpr int kLd = kT + 4;             // row stride of the score tile
constexpr int kThreads = 256;           // 16 x 16
constexpr int kMaxN = 128;              // state_dim
constexpr int kNM = 8;                  // state columns per thread (update)
constexpr int kMaxPt = 64;              // P columns per block
constexpr int kMaxL = 4096;             // chunk length

static_assert(16 * kNM == kMaxN, "the update's threads cover kMaxN");

struct Args {
  const float* x;
  const float* a;
  const void* b;
  const void* c;
  const float* s0;
  float* y;
  float* sf;
  int seq, heads, p, n, len, pt;        // len: chunk length; pt: P per block
  // (batch, seq, head) element strides of x, a, b, c, y; s0: (batch, head, p)
  long long xs[3], as[3], bs[3], cs[3], ys[3], ss[3];
};

template <typename TB>
constexpr bool kTensorCores = std::is_same<TB, __nv_bfloat16>::value;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// the row stride, in elements, of the row-major B/C sub-tiles: N rounded up
// to 16 (the mma's k), plus a skew that keeps rows 16-byte aligned and
// sends fragment loads of neighbouring rows to other banks
template <typename TB>
__host__ __device__ inline int tile_ld(int n) {
  return pad16(n) + (kTensorCores<TB> ? 8 : 4);
}

// four consecutive values of a sub-tile row (16-byte aligned), as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// dst[r * ld + c] = g[(row0 + r) * rs + c] for r < rows, c < n, zero up to
// the padded width.  Thread (tx, ty) takes rows ty + 16k and columns
// tx + 16m, with trip counts fixed at compile time, and issues all its
// global loads before its first store: one memory latency per tile.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* g,
                                          long long row0, long long rs,
                                          int rows, int n) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, np = pad16(n);
  T v[kT / 16][kMaxN / 16];
#pragma unroll
  for (int k = 0; k < kT / 16; ++k) {
    const int r = ty + 16 * k;
    const T* row = g + (row0 + r) * rs;
#pragma unroll
    for (int m = 0; m < kMaxN / 16; ++m) {
      const int c = tx + 16 * m;
      v[k][m] = (r < rows && c < n) ? row[c] : T(0.f);
    }
  }
#pragma unroll
  for (int k = 0; k < kT / 16; ++k)
#pragma unroll
    for (int m = 0; m < kMaxN / 16; ++m) {
      const int c = tx + 16 * m;
      if (c < np) dst[(ty + 16 * k) * ld + c] = v[k][m];
    }
}

// dst[r * pt + c] = g[(row0 + r) * rs + c] for r < rows, c < live, else 0;
// pt <= 16 * PC
template <int PC>
__device__ __forceinline__ void load_x(float* dst, const float* g,
                                       long long row0, long long rs,
                                       int rows, int pt, int live) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float v[kT / 16][PC];
#pragma unroll
  for (int k = 0; k < kT / 16; ++k) {
    const int r = ty + 16 * k;
    const float* row = g + (row0 + r) * rs;
#pragma unroll
    for (int m = 0; m < PC; ++m) {
      const int c = tx + 16 * m;
      v[k][m] = (r < rows && c < live) ? row[c] : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kT / 16; ++k)
#pragma unroll
    for (int m = 0; m < PC; ++m) {
      const int c = tx + 16 * m;
      if (c < pt) dst[(ty + 16 * k) * pt + c] = v[k][m];
    }
}

// one 16 x 8 x 16 tensor-core product, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the masked score of row r (in the i-tile) and column c (in the j-tile).
// Below the diagonal tile every (r, c) is visible and, with i0 between
// them, exp(a_cum[r] - a_cum[c]) = rf[r] * cf[c]; on the diagonal tile each
// score takes its own exp, and only where c <= r.
__device__ __forceinline__ float masked(float s, int r, int c, int i0, int j0,
                                        int L, const double* acum,
                                        const float* rf, const float* cf) {
  if (j0 < i0) return s * rf[r] * cf[c];
  const int ri = i0 + r, cj = j0 + c;
  return (cj <= ri && ri < L) ? s * expf((float)(acum[ri] - acum[cj])) : 0.f;
}

template <typename TB, int PC>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int N = a.n, Np = pad16(a.n), Pt = a.pt, L = a.len;
  const int ld = tile_ld<TB>(N);
  float* st = reinterpret_cast<float*>(smem4);  // [Np][Pt] state, n-major
  double* acum = reinterpret_cast<double*>(st + Np * Pt);       // [L]
  TB* ct = reinterpret_cast<TB*>(acum + ((L + 1) & ~1));  // [kT][ld] C
  TB* bt = ct + kT * ld;                                  // [kT][ld] B
  float* xt = reinterpret_cast<float*>(bt + kT * ld);     // [kT][Pt] x
  float* sc = xt + kT * Pt;                     // [kT][kLd] masked scores
  float* ws = sc + kT * kLd;                    // [kT] exp(last - a_cum)
  float* rf = ws + kT;                          // [kT] exp(a_cum[r] - a_cum[i0])
  float* cf = rf + kT;                          // [kT] exp(a_cum[i0] - a_cum[c])

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int p0 = blockIdx.x * Pt, h = blockIdx.y, b = blockIdx.z;
  const int live = min(Pt, a.p - p0);           // P columns of this block
  const float* xg = a.x + b * a.xs[0] + h * a.xs[2] + p0;
  const float* ag = a.a + b * a.as[0] + h * a.as[2];
  const TB* bg = static_cast<const TB*>(a.b) + b * a.bs[0] + h * a.bs[2];
  const TB* cg = static_cast<const TB*>(a.c) + b * a.cs[0] + h * a.cs[2];
  float* yg = a.y + b * a.ys[0] + h * a.ys[2] + p0;
  const float* s0g = a.s0 + b * a.ss[0] + h * a.ss[1] + p0 * a.ss[2];

  for (int i = tid; i < Pt * Np; i += kThreads) {
    const int p = i / Np, n = i % Np;
    st[n * Pt + p] = (p < live && n < N) ? s0g[p * a.ss[2] + n] : 0.f;
  }

  const int n_chunks = a.seq / L, n_tiles = (L + kT - 1) / kT;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const long long r0 = (long long)ch * L;
    __syncthreads();              // the previous chunk's readers are done
    if (tid < 32) {               // inclusive scan of a, 32 steps at a time
      double carry = 0.0;
      for (int base = 0; base < L; base += 32) {
        const int l = base + tid;
        double v = l < L ? (double)ag[(r0 + l) * a.as[1]] : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (l < L) acum[l] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const double last = acum[L - 1];

    float up[PC][kNM];            // the state update, in the last i-tile
    // ---- y of each 64-row i-tile, from the incoming state
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT, ni = min(kT, L - i0);
      const bool last_tile = it == n_tiles - 1;
      load_tile(ct, ld, cg, r0 + i0, a.cs[1], ni, N);
      if (tid < kT)
        rf[tid] = tid < ni ? expf((float)(acum[i0 + tid] - acum[i0])) : 0.f;
      __syncthreads();

      float acc[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[i][k] = 0.f;
      // carried-state term: (C state^T) * exp(a_cum)
      for (int n = 0; n < Np; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = load4(&ct[(ty * 4 + i) * ld + n]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < PC; ++k) {
            const int col = tx + 16 * k;
            const float sv = col < Pt ? st[(n + q) * Pt + col] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[i][k] = fmaf(lane4(cv[i], q), sv, acc[i][k]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i0 + ty * 4 + i;
        const float e = r < L ? expf((float)acum[r]) : 0.f;
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[i][k] = acc[i][k] * e;
      }
      if (last_tile) {
        const float keep = expf((float)last);
#pragma unroll
        for (int k = 0; k < PC; ++k)
#pragma unroll
          for (int m = 0; m < kNM; ++m) {
            const int n = ty * kNM + m, col = tx + 16 * k;
            up[k][m] = (n < Np && col < Pt) ? st[n * Pt + col] * keep : 0.f;
          }
      }

      // intra-chunk term over the j-tiles at or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT, nj = min(kT, L - j0);
        __syncthreads();          // the previous j-tile's readers are done
        load_tile(bt, ld, bg, r0 + j0, a.bs[1], nj, N);
        load_x<PC>(xt, xg, r0 + j0, a.xs[1], nj, Pt, live);
        if (tid < kT) {
          if (last_tile)
            ws[tid] = tid < nj ? expf((float)(last - acum[j0 + tid])) : 0.f;
          if (jt < it) cf[tid] = expf((float)(acum[i0] - acum[j0 + tid]));
        }
        __syncthreads();

        if constexpr (kTensorCores<TB>) {
          // warp w: score rows 16 (w % 4) .., columns 32 (w / 4) ..
          const int lane = tid & 31, w = tid >> 5;
          const int g = lane >> 2, t = lane & 3;
          const int rb = (w & 3) * 16, cb = (w >> 2) * 32;
          float d[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) d[j][q] = 0.f;
          const __nv_bfloat16* ar = ct + (rb + g) * ld + 2 * t;
          for (int k0 = 0; k0 < Np; k0 += 16) {
            const uint32_t a0 = ld32(ar + k0), a1 = ld32(ar + 8 * ld + k0);
            const uint32_t a2 = ld32(ar + k0 + 8);
            const uint32_t a3 = ld32(ar + 8 * ld + k0 + 8);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const __nv_bfloat16* br = bt + (cb + 8 * j + g) * ld + 2 * t;
              mma_bf16(d[j], a0, a1, a2, a3, ld32(br + k0),
                       ld32(br + k0 + 8));
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = cb + 8 * j + 2 * t;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = rb + g + 8 * half;
              *reinterpret_cast<float2*>(&sc[r * kLd + c]) = make_float2(
                  masked(d[j][2 * half], r, c, i0, j0, L, acum, rf, cf),
                  masked(d[j][2 * half + 1], r, c + 1, i0, j0, L, acum, rf,
                         cf));
            }
          }
        } else {
          // thread (tx, ty): score rows 4 ty .., columns tx + 16 j
          float s[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
          for (int n = 0; n < Np; n += 4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              cv[i] = load4(&ct[(ty * 4 + i) * ld + n]);
              bv[i] = load4(&bt[(tx + 16 * i) * ld + n]);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  s[i][j] = fmaf(lane4(cv[i], q), lane4(bv[j], q), s[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sc[r * kLd + tx + 16 * j] =
                  masked(s[i][j], r, tx + 16 * j, i0, j0, L, acum, rf, cf);
          }
        }

        if (last_tile && ty * kNM < Np) {
          // state update: x^T (B * exp(last - a_cum)), as (x * w)^T B;
          // thread (tx, ty) owns state rows n = 8 ty .. 8 ty + 7
          const int n0 = ty * kNM;
          for (int l = 0; l < nj; ++l) {
            const float w = ws[l];
            float xv[PC];
#pragma unroll
            for (int k = 0; k < PC; ++k) {
              const int col = tx + 16 * k;
              xv[k] = col < Pt ? xt[l * Pt + col] * w : 0.f;
            }
            const float4 b0 = load4(&bt[l * ld + n0]);
            const float4 b1 = load4(&bt[l * ld + n0 + 4]);
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
              for (int k = 0; k < PC; ++k) {
                up[k][m] = fmaf(xv[k], lane4(b0, m), up[k][m]);
                up[k][m + 4] = fmaf(xv[k], lane4(b1, m), up[k][m + 4]);
              }
          }
        }
        __syncthreads();          // sc is complete

        const int nj4 = (nj + 3) & ~3;  // rows past nj hold zeros
        for (int cc = 0; cc < nj4; cc += 4) {
          float4 sr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sr[i] = *reinterpret_cast<const float4*>(
                &sc[(ty * 4 + i) * kLd + cc]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int k = 0; k < PC; ++k) {
              const int col = tx + 16 * k;
              const float xv = col < Pt ? xt[(cc + q) * Pt + col] : 0.f;
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[i][k] = fmaf(lane4(sr[i], q), xv, acc[i][k]);
            }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= ni) continue;
#pragma unroll
        for (int k = 0; k < PC; ++k) {
          const int col = tx + 16 * k;
          if (col < live) yg[(r0 + i0 + r) * a.ys[1] + col] = acc[i][k];
        }
      }
      __syncthreads();            // before the next i-tile reloads ct
    }

    // every reader of the incoming state is past the barrier above
#pragma unroll
    for (int k = 0; k < PC; ++k)
#pragma unroll
      for (int m = 0; m < kNM; ++m) {
        const int n = ty * kNM + m, col = tx + 16 * k;
        if (n < Np && col < Pt) st[n * Pt + col] = up[k][m];
      }
  }

  __syncthreads();
  float* sfg = a.sf + ((long long)(b * a.heads + h) * a.p + p0) * N;
  for (int i = tid; i < live * N; i += kThreads) {
    const int p = i / N, n = i % N;
    sfg[p * N + n] = st[n * Pt + p];
  }
}

template <typename TB>
size_t smem_bytes(int n, int pt, int len) {
  const size_t np = pad16(n);
  return sizeof(float) * (np * pt + (size_t)kT * pt + (size_t)kT * kLd +
                          3 * kT) +
         sizeof(double) * (size_t)((len + 1) & ~1) +
         2 * sizeof(TB) * (size_t)kT * tile_ld<TB>(n);
}

// set the kernel's shared-memory ceiling to smem (once it is needed) and
// report how many of its blocks fit on one SM at that size
template <typename TB, int PC>
cudaError_t configure(size_t smem, int* per_sm) {
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<TB, PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  return per_sm == nullptr
             ? cudaSuccess
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   per_sm, ssd_kernel<TB, PC>, kThreads, smem);
}

template <typename TB>
cudaError_t configure_pt(int pt, size_t smem, int* per_sm) {
  const int pc = (pt + 15) / 16;
  if (pc <= 1) return configure<TB, 1>(smem, per_sm);
  if (pc <= 2) return configure<TB, 2>(smem, per_sm);
  return configure<TB, 4>(smem, per_sm);
}

template <typename TB>
int launch(Args& a, int batch, int n_sm, cudaStream_t stream) {
  // halve the P tile while twice the blocks still fit in one wave
  int pt = a.p < kMaxPt ? a.p : kMaxPt;
  while (pt >= 32) {
    const int half = (pt + 1) / 2;
    const int blocks = ((a.p + half - 1) / half) * a.heads * batch;
    int per_sm = 0;
    const cudaError_t err = configure_pt<TB>(
        half, smem_bytes<TB>(a.n, half, a.len), &per_sm);
    if (err != cudaSuccess) return (int)err;
    if (blocks > n_sm * per_sm) break;
    pt = half;
  }
  a.pt = pt;
  const size_t smem = smem_bytes<TB>(a.n, pt, a.len);
  const cudaError_t err = configure_pt<TB>(pt, smem, nullptr);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.p + pt - 1) / pt), (unsigned)a.heads,
                  (unsigned)batch);
  const int pc = (pt + 15) / 16;
  if (pc <= 1)
    ssd_kernel<TB, 1><<<grid, kThreads, smem, stream>>>(a);
  else if (pc <= 2)
    ssd_kernel<TB, 2><<<grid, kThreads, smem, stream>>>(a);
  else
    ssd_kernel<TB, 4><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, P) f32, a (B, S, H) f32, b and c (B, S, H, N) f32 or bf16
// (bc_bf16), s0 (B, H, P, N) f32 -> y (B, S, H, P) f32, sf (B, H, P, N) f32
// contiguous.  strides: 18 element strides, (batch, seq, head) of x, a, b,
// c and y, then (batch, head, p) of s0; the last dimension of x, b, c, y
// and s0 is contiguous.  chunk_len divides seq.
extern "C" int ssd_scan_launch(const float* x, const float* a, const void* b,
                               const void* c, const float* s0, float* y,
                               float* sf, int bc_bf16, int batch, int seq,
                               int heads, int p, int n, int chunk_len,
                               const long long* strides, void* stream) {
  if (batch <= 0 || heads <= 0 || p <= 0 || n <= 0 || n > kMaxN ||
      chunk_len <= 0 || chunk_len > kMaxL || seq % chunk_len != 0 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
  }
  Args args;
  args.x = x; args.a = a; args.b = b; args.c = c; args.s0 = s0;
  args.y = y; args.sf = sf;
  args.seq = seq; args.heads = heads; args.p = p; args.n = n;
  args.len = chunk_len; args.pt = 0;
  for (int i = 0; i < 3; ++i) {
    args.xs[i] = strides[i];
    args.as[i] = strides[3 + i];
    args.bs[i] = strides[6 + i];
    args.cs[i] = strides[9 + i];
    args.ys[i] = strides[12 + i];
    args.ss[i] = strides[15 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  return bc_bf16 ? launch<__nv_bfloat16>(args, batch, n_sm, s)
                 : launch<float>(args, batch, n_sm, s);
}

// the kernel's limits, for the host side's checks: 0 -> largest state_dim,
// 1 -> largest chunk length
extern "C" int ssd_scan_limit(int which) { return which == 0 ? kMaxN : kMaxL; }

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
