// Kernel D: the whole block-NTT blind rotation (all n CMUX steps) in one
// launch.
//
// Replaces: tfhe_tpu/ops/pallas/ntt_kernel.py, blind_rotate_nttf (body
// _kernel_nttf).  Per step s and sample b, with a = a_hat[s, b] mod 2N:
//
//   rot[p, m]  = (-1)^floor(((m - a) mod 2N) / N) * acc[p, (m - a) mod N]
//   d[r, m]    = reference carry-chain digits of rot - acc, r = p*levels + j
//   per CRT prime p in {12289, 40961}, with m = i*N2 + j1:
//     Dh[bin, (r,j1)]     = sum_i w_fwd[i, bin] * d[r, i*N2 + j1]            (mod p)
//     Ch[bin, q]          = sum_(r,j1) Dh[bin, (r,j1)] * K[s, p, bin, q, (r,j1)] (mod p)
//     res_p[q, i]         = sum_bin w_inv[bin, i] * Ch[bin, q]                (mod p)
//   with q = (c*L + lam)*N2 + j_out, then the centered CRT lift
//     S = r1 + p1 * center((r2 - r1) * p1^-1 mod p2)   (|S| < p1*p2/2: exact)
//   and acc[c, i*N2 + j_out] += sum_lam S << (key_bits*lam)   (mod 2^32).
//
// K is the key as the JAX package lays it out (ops/ntt.py:ntt_key_lhs_form):
// bk_lhs int8[n, P, N1, 2*CLN2, RN2], rows (key byte hi/lo, q), columns
// (r, j1) with r in canonical order, the twisted-circulant Z-twist folded in.
// Every residue is exact, so the result equals impl='fused' bit for bit.
//
// What bounds it on the H100: integer multiply-adds.  Per sample and step
// the forward transforms take 2*RN2*N1*N1 residue products, the per-bin
// contraction 2*N1*CLN2*RN2 and the inverse transforms 2*CLN2*N1*N1: 3.1e6 at
// default_128 (N1=64, N2=8, RN2=144, CLN2=72).  The residues ride in two
// balanced bytes, as in the TPU kernel, so a forward product is two int8
// products (the digits are single bytes) and the others four: 1.0e7 int8
// multiply-adds per sample-step, 7.4e12 for B=1024 over 722 steps, 7.5 ms at
// the int8 tensor-core peak.  The key (1.92 GB, 0.57 ms at 3.35 TB/s) is read
// from device memory about once, since all CTAs walk the steps at about the
// same pace and one step's key block (2.65 MB) sits in L2; each CTA reads the
// block once per step from L2.  This first design runs on the CUDA cores,
// four int8 products per __dp4a: 2.5e6 dp4a per sample-step.
//
// Design: the TPU kernel absorbs the strided split m = i*N2 + j1 into dense
// int8[N, N] transform matrices (N2 = 8 times the transform's work) because
// Mosaic cannot relayout it; here the digits are written straight into
// [r][j1][i] rows and each (r, j1) column gets its own [N1, N1] transform.
// The TPU's float32-reciprocal mod becomes an exact integer % by a
// compile-time prime.  Each CTA owns S samples (4 at default_128 and
// B=1024, fewer for small batches) for all n steps with no
// inter-CTA synchronisation, and keeps in shared memory their accumulators,
// digits, transformed digits, per-bin products and the first prime's
// residues, plus the current prime's transform tables (226 KB at S=4; S is
// picked per batch so the waves of CTAs finish soonest).  A
// step is eight phases between barriers: digits; then per prime forward,
// contraction, inverse.  In every phase a thread owns a register tile over
// all S samples (forward: 4 bins of one column; contraction: 2 key rows of
// one bin, key read as 16-byte loads; inverse: 4 coefficients of one
// (c, j_out) for every key limb), and the int8 operands are packed four to
// a word along the contracted axis for __dp4a.  Rows read by the transforms
// are padded by one word against bank conflicts.  Tensor cores (int8 mma on
// the per-bin products), TMA staging of the key and sharing it across a
// cluster are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kP1 = 12289, kP2 = 40961;
constexpr int kThreads = 384;
constexpr int kQt = 2;   // key rows q per thread in the contraction
constexpr int kPad = 4;  // bytes of padding on rows of length N1

struct Shape {
  int n_steps, B, C, N, levels, log_base, ignored_bits;
  int N1, N2, R, RN2, CLN2, key_bits, inv_p1;
  // byte offsets of the shared-memory sections
  int off_r1, off_dig, off_dh, off_ch, off_tabf, off_tabi, off_a, smem;
};

template <int P>
__device__ __forceinline__ int center(int x) {
  int r = x % P;  // in (-P, P), with the sign of x
  if (r > P / 2) r -= P;
  else if (r < -(P / 2)) r += P;
  return r;
}

// (hh*256 + m)*256 + ll mod P, centered, every plane reduced first
template <int P>
__device__ __forceinline__ int combine3(int hh, int m, int ll) {
  const int x = center<P>(center<P>(hh) * 256 + center<P>(m));
  return center<P>(x * 256 + center<P>(ll));
}

// centered x -> balanced bytes x = hi*256 + lo, lo in [-128, 128)
__device__ __forceinline__ void split2(int x, int8_t* hi, int8_t* lo) {
  const int l = ((x + 128) & 255) - 128;
  *lo = static_cast<int8_t>(l);
  *hi = static_cast<int8_t>((x - l) / 256);
}

__device__ __forceinline__ int ld32(const int8_t* p) { return *reinterpret_cast<const int*>(p); }

// Signed digits of one u32 value by the reference carry chain
// (src/decomposer.rs:42-80), written MSB-first at out[j * stride].
__device__ __forceinline__ void decompose(uint32_t diff, const Shape& s, int8_t* out,
                                          int stride) {
  const uint32_t mask = (1u << s.log_base) - 1u;
  const int half = 1 << (s.log_base - 1);
  const int ig = s.ignored_bits;
  // round_value, then the chain from the first kept digit: the digits below
  // it are zero after rounding
  const uint32_t v = ig ? (diff >> ig) + ((diff >> (ig - 1)) & 1u) : diff;
  int carry = 0;
  for (int l = 0; l < s.levels; ++l) {
    int res = static_cast<int>((v >> (s.log_base * l)) & mask) + carry;
    const int cm = res & half;
    res -= cm << 1;  // in [-B/2, B]: the +B anomaly stays
    carry = cm >> (s.log_base - 1);
    out[(s.levels - 1 - l) * stride] = static_cast<int8_t>(res);
  }
}

// two planes [2][N1][N1] of the global tables -> shared rows of stride N1+kPad
__device__ __forceinline__ void load_tables(int8_t* dst, const int8_t* __restrict__ src,
                                            int N1) {
  const int words = N1 / 4, np = N1 + kPad;
  for (int idx = threadIdx.x; idx < 2 * N1 * words; idx += blockDim.x) {
    const int row = idx / words, w = idx - row * words;
    *reinterpret_cast<int*>(dst + row * np + 4 * w) = ld32(src + row * N1 + 4 * w);
  }
}

// Dh[sb][bin][col] = w_fwd . d over i (mod P), stored as hi/lo byte planes.
// A thread owns the bins bg + G*b (b < 4) of one column for all S samples.
template <int S, int P>
__device__ void forward(const Shape& s, const int8_t* dig, const int8_t* tabf, int8_t* dh) {
  const int N1 = s.N1, N2 = s.N2, np = N1 + kPad, G = N1 / 4;
  const int sample_dig = s.R * N2 * np, sample_dh = N1 * s.RN2;
  for (int u = threadIdx.x; u < s.RN2 * G; u += blockDim.x) {
    const int bg = u % G, col = u / G;
    const int8_t* drow = dig + col * np;  // col = r*N2 + j1 is the row index
    int hi[S][4], lo[S][4];
#pragma unroll
    for (int sb = 0; sb < S; ++sb)
#pragma unroll
      for (int b = 0; b < 4; ++b) hi[sb][b] = lo[sb][b] = 0;
    for (int i0 = 0; i0 < N1; i0 += 4) {
      int dv[S];
#pragma unroll
      for (int sb = 0; sb < S; ++sb) dv[sb] = ld32(drow + sb * sample_dig + i0);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int wh = ld32(tabf + (bg + G * b) * np + i0);
        const int wl = ld32(tabf + (N1 + bg + G * b) * np + i0);
#pragma unroll
        for (int sb = 0; sb < S; ++sb) {
          hi[sb][b] = __dp4a(dv[sb], wh, hi[sb][b]);
          lo[sb][b] = __dp4a(dv[sb], wl, lo[sb][b]);
        }
      }
    }
#pragma unroll
    for (int sb = 0; sb < S; ++sb)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int x = center<P>(center<P>(hi[sb][b]) * 256 + center<P>(lo[sb][b]));
        const int at = sb * sample_dh + (bg + G * b) * s.RN2 + col;
        split2(x, dh + at, dh + S * sample_dh + at);
      }
  }
}

__device__ __forceinline__ void dot4(int xh, int xl, int kh, int kl, int& hh, int& mm,
                                     int& ll) {
  hh = __dp4a(xh, kh, hh);
  mm = __dp4a(xh, kl, mm);
  mm = __dp4a(xl, kh, mm);
  ll = __dp4a(xl, kl, ll);
}

// Ch[sb][q][bin] = Dh[sb][bin] . K[bin][q] over (r, j1) (mod P), stored as
// hi/lo byte planes.  A thread owns kQt key rows of one bin for all S samples.
template <int S, int P>
__device__ void contract(const Shape& s, const int8_t* __restrict__ kprime, const int8_t* dh,
                         int8_t* ch) {
  const int N1 = s.N1, RN2 = s.RN2, CLN2 = s.CLN2, np = N1 + kPad;
  const int QP = CLN2 / kQt, sample_dh = N1 * RN2, sample_ch = CLN2 * np;
  for (int u = threadIdx.x; u < N1 * QP; u += blockDim.x) {
    const int bin = u / QP, q0 = (u - bin * QP) * kQt;
    const int8_t* kb = kprime + static_cast<size_t>(bin) * 2 * CLN2 * RN2;
    const int8_t* dH = dh + bin * RN2;
    const int8_t* dL = dH + S * sample_dh;
    int hh[S][kQt], mm[S][kQt], ll[S][kQt];
#pragma unroll
    for (int sb = 0; sb < S; ++sb)
#pragma unroll
      for (int q = 0; q < kQt; ++q) hh[sb][q] = mm[sb][q] = ll[sb][q] = 0;
    if ((RN2 & 15) == 0) {
      for (int c = 0; c < RN2; c += 16) {
        int4 kh[kQt], kl[kQt];
#pragma unroll
        for (int q = 0; q < kQt; ++q) {
          kh[q] = __ldg(reinterpret_cast<const int4*>(kb + (q0 + q) * RN2 + c));
          kl[q] = __ldg(reinterpret_cast<const int4*>(kb + (CLN2 + q0 + q) * RN2 + c));
        }
#pragma unroll
        for (int sb = 0; sb < S; ++sb) {
          const int4 xh = *reinterpret_cast<const int4*>(dH + sb * sample_dh + c);
          const int4 xl = *reinterpret_cast<const int4*>(dL + sb * sample_dh + c);
#pragma unroll
          for (int q = 0; q < kQt; ++q) {
            dot4(xh.x, xl.x, kh[q].x, kl[q].x, hh[sb][q], mm[sb][q], ll[sb][q]);
            dot4(xh.y, xl.y, kh[q].y, kl[q].y, hh[sb][q], mm[sb][q], ll[sb][q]);
            dot4(xh.z, xl.z, kh[q].z, kl[q].z, hh[sb][q], mm[sb][q], ll[sb][q]);
            dot4(xh.w, xl.w, kh[q].w, kl[q].w, hh[sb][q], mm[sb][q], ll[sb][q]);
          }
        }
      }
    } else {
      for (int c = 0; c < RN2; c += 4) {
        int kh[kQt], kl[kQt];
#pragma unroll
        for (int q = 0; q < kQt; ++q) {
          kh[q] = __ldg(reinterpret_cast<const int*>(kb + (q0 + q) * RN2 + c));
          kl[q] = __ldg(reinterpret_cast<const int*>(kb + (CLN2 + q0 + q) * RN2 + c));
        }
#pragma unroll
        for (int sb = 0; sb < S; ++sb) {
          const int xh = ld32(dH + sb * sample_dh + c), xl = ld32(dL + sb * sample_dh + c);
#pragma unroll
          for (int q = 0; q < kQt; ++q)
            dot4(xh, xl, kh[q], kl[q], hh[sb][q], mm[sb][q], ll[sb][q]);
        }
      }
    }
#pragma unroll
    for (int sb = 0; sb < S; ++sb)
#pragma unroll
      for (int q = 0; q < kQt; ++q) {
        const int at = sb * sample_ch + (q0 + q) * np + bin;
        split2(combine3<P>(hh[sb][q], mm[sb][q], ll[sb][q]), ch + at, ch + S * sample_ch + at);
      }
  }
}

// res[q][i] = w_inv . Ch[q] over bins (mod P) for q = (c*L + lam)*N2 + j_out.
// A thread owns the coefficients i = ig + G*t (t < 4) of one (sample, c,
// j_out) for every lam.  The first prime's residues go to r1; the second
// prime lifts them by CRT and adds sum_lam S << (key_bits*lam) to acc.
template <int S, int L, int P, bool kLift>
__device__ void inverse(const Shape& s, const int8_t* ch, const int8_t* tabi, int16_t* r1,
                        uint32_t* acc) {
  const int N1 = s.N1, N2 = s.N2, C = s.C, CLN2 = s.CLN2, np = N1 + kPad, G = N1 / 4;
  const int sample_ch = CLN2 * np;
  for (int u = threadIdx.x; u < S * C * N2 * G; u += blockDim.x) {
    const int ig = u % G;
    int rest = u / G;
    const int jout = rest % N2;
    rest /= N2;
    const int c = rest % C, sb = rest / C;
    const int q0 = c * L * N2 + jout;  // q of lam = 0; lam steps by N2 rows
    const int8_t* cH = ch + sb * sample_ch + q0 * np;
    const int8_t* cL = cH + S * sample_ch;
    int hh[L][4], mm[L][4], ll[L][4];
#pragma unroll
    for (int lam = 0; lam < L; ++lam)
#pragma unroll
      for (int t = 0; t < 4; ++t) hh[lam][t] = mm[lam][t] = ll[lam][t] = 0;
    for (int k0 = 0; k0 < N1; k0 += 4) {
      int wh[4], wl[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        wh[t] = ld32(tabi + (ig + G * t) * np + k0);
        wl[t] = ld32(tabi + (N1 + ig + G * t) * np + k0);
      }
#pragma unroll
      for (int lam = 0; lam < L; ++lam) {
        const int xh = ld32(cH + lam * N2 * np + k0), xl = ld32(cL + lam * N2 * np + k0);
#pragma unroll
        for (int t = 0; t < 4; ++t) dot4(xh, xl, wh[t], wl[t], hh[lam][t], mm[lam][t], ll[lam][t]);
      }
    }
    uint32_t delta[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int lam = 0; lam < L; ++lam)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int res = combine3<P>(hh[lam][t], mm[lam][t], ll[lam][t]);
        int16_t* r1p = r1 + (sb * CLN2 + q0 + lam * N2) * N1 + ig + G * t;
        if (!kLift) {
          *r1p = static_cast<int16_t>(res);
        } else {
          const int a = *r1p;
          const int sv = a + kP1 * center<kP2>((res - a) * s.inv_p1);  // |.| < 2^31
          delta[t] += static_cast<uint32_t>(sv) << (s.key_bits * lam);
        }
      }
    if (kLift) {
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[(sb * C + c) * s.N + (ig + G * t) * N2 + jout] += delta[t];
    }
  }
}

template <int S, int L>
__global__ void __launch_bounds__(kThreads, 1)
ntt_kernel(const uint32_t* __restrict__ acc0, const int8_t* __restrict__ bk,
           const int32_t* __restrict__ a_hat, const int8_t* __restrict__ tables,
           uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = s.N, CN = s.C * N, N1 = s.N1, N2 = s.N2, np = N1 + kPad;
  const int mask2 = 2 * N - 1;
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);              // [S][C][N]
  int16_t* r1 = reinterpret_cast<int16_t*>(smem + s.off_r1);      // [S][CLN2][N1]
  int8_t* dig = reinterpret_cast<int8_t*>(smem + s.off_dig);      // [S][R][N2][np]
  int8_t* dh = reinterpret_cast<int8_t*>(smem + s.off_dh);        // [2][S][N1][RN2]
  int8_t* ch = reinterpret_cast<int8_t*>(smem + s.off_ch);        // [2][S][CLN2][np]
  int8_t* tabf = reinterpret_cast<int8_t*>(smem + s.off_tabf);    // [2][N1 bin][np i]
  int8_t* tabi = reinterpret_cast<int8_t*>(smem + s.off_tabi);    // [2][N1 i][np bin]
  int* a_s = reinterpret_cast<int*>(smem + s.off_a);              // [S]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * S;
  const int nb = min(S, s.B - b0);
  const size_t table = static_cast<size_t>(N1) * N1;  // one plane
  const size_t prime_key = static_cast<size_t>(N1) * 2 * s.CLN2 * s.RN2;

  for (int idx = tid; idx < S * CN; idx += nthr)
    acc[idx] = idx / CN < nb ? acc0[static_cast<size_t>(b0) * CN + idx] : 0u;

  for (int step = 0; step < s.n_steps; ++step) {
    const int8_t* kstep = bk + static_cast<size_t>(step) * 2 * prime_key;
    if (tid < S)
      a_s[tid] = tid < nb ? (a_hat[static_cast<size_t>(step) * s.B + b0 + tid] & mask2) : 0;
    load_tables(tabf, tables, N1);  // w_fwd planes of the first prime
    __syncthreads();
    for (int idx = tid; idx < S * CN; idx += nthr) {
      const int sb = idx / CN, rem = idx - sb * CN;
      const int p = rem / N, m = rem - p * N;
      const int src = (m - a_s[sb]) & mask2;
      uint32_t rot = acc[sb * CN + p * N + (src & (N - 1))];
      if (src >= N) rot = 0u - rot;
      const int i = m / N2, j1 = m - i * N2;
      decompose(rot - acc[idx], s, dig + ((sb * s.R + p * s.levels) * N2 + j1) * np + i,
                N2 * np);
    }
    __syncthreads();
    forward<S, kP1>(s, dig, tabf, dh);
    __syncthreads();
    contract<S, kP1>(s, kstep, dh, ch);
    load_tables(tabi, tables + 2 * table, N1);  // w_inv planes, first prime
    load_tables(tabf, tables + 4 * table, N1);  // w_fwd planes, second prime
    __syncthreads();
    inverse<S, L, kP1, false>(s, ch, tabi, r1, acc);
    __syncthreads();
    forward<S, kP2>(s, dig, tabf, dh);
    __syncthreads();
    contract<S, kP2>(s, kstep + prime_key, dh, ch);
    load_tables(tabi, tables + 6 * table, N1);  // w_inv planes, second prime
    __syncthreads();
    inverse<S, L, kP2, true>(s, ch, tabi, r1, acc);
    __syncthreads();
  }
  for (int idx = tid; idx < nb * CN; idx += nthr)
    out[static_cast<size_t>(b0) * CN + idx] = acc[idx];
}

int align16(int x) { return (x + 15) & ~15; }

// the shared-memory layout for S samples per CTA; returns its size in bytes
int layout(Shape& s, int S) {
  const int np = s.N1 + kPad;
  int off = align16(S * s.C * s.N * 4);
  s.off_r1 = off;
  off += align16(S * s.CLN2 * s.N1 * 2);
  s.off_dig = off;
  off += align16(S * s.R * s.N2 * np);
  s.off_dh = off;
  off += align16(2 * S * s.N1 * s.RN2);
  s.off_ch = off;
  off += align16(2 * S * s.CLN2 * np);
  s.off_tabf = off;
  off += align16(2 * s.N1 * np);
  s.off_tabi = off;
  off += align16(2 * s.N1 * np);
  s.off_a = off;
  off += align16(S * 4);
  s.smem = off;
  return off;
}

int mod_pow(long long b, long long e, long long m) {
  long long r = 1;
  for (b %= m; e; e >>= 1, b = b * b % m)
    if (e & 1) r = r * b % m;
  return static_cast<int>(r);
}

template <int S, int L>
cudaError_t launch(const void* acc0, const void* bk, const void* a_hat, const void* tables,
                   void* out, const Shape& s, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ntt_kernel<S, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
  if (err != cudaSuccess) return err;
  ntt_kernel<S, L><<<(s.B + S - 1) / S, kThreads, s.smem, stream>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const int8_t*>(bk),
      static_cast<const int32_t*>(a_hat), static_cast<const int8_t*>(tables),
      static_cast<uint32_t*>(out), s);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_s(int S, const void* acc0, const void* bk, const void* a_hat,
                     const void* tables, void* out, const Shape& s, cudaStream_t stream) {
  if (S == 4) return launch<4, L>(acc0, bk, a_hat, tables, out, s, stream);
  if (S == 2) return launch<2, L>(acc0, bk, a_hat, tables, out, s, stream);
  return launch<1, L>(acc0, bk, a_hat, tables, out, s, stream);
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N]; bk_lhs int8 [n, 2, N1, 2*CLN2, RN2]; a_hat int32 [n, B];
// tables int8 [2 primes][4][N1][N1]: w_fwd^T hi, lo ([bin][i]) and w_inv^T
// hi, lo ([i][bin]), balanced bytes of the centered tables -> out u32
// [B, C, N].  Takes N a power of two, N1 a power of two with 4 <= N1 <= 128
// dividing N (any N2 = N/N1), R*N2 a multiple of 4, C*key_limbs*N2 even,
// key_limbs 3 or 4, log_base <= 6 and B >= 1, when S=1 sample's shared
// memory fits the card; returns cudaErrorInvalidValue for anything else.
// info[0..3] <- samples per CTA, threads, shared bytes, CTAs.
int blind_rotate_nttf(const void* acc0, const void* bk_lhs, const void* a_hat,
                      const void* tables, void* out, int n_steps, int B, int C, int N,
                      int levels, int log_base, int ignored_bits, int N1, int key_bits,
                      int key_limbs, int* info, void* stream) {
  if (N < 4 || (N & (N - 1)) || N1 < 4 || N1 > 128 || (N1 & (N1 - 1)) || N % N1 || C < 1 ||
      B < 1 || levels < 1 || log_base < 1 || log_base > 6 || (key_limbs != 3 && key_limbs != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{};
  s.n_steps = n_steps;
  s.B = B;
  s.C = C;
  s.N = N;
  s.levels = levels;
  s.log_base = log_base;
  s.ignored_bits = ignored_bits;
  s.N1 = N1;
  s.N2 = N / N1;
  s.R = C * levels;
  s.RN2 = s.R * s.N2;
  s.CLN2 = C * key_limbs * s.N2;
  s.key_bits = key_bits;
  s.inv_p1 = mod_pow(kP1, kP2 - 2, kP2);
  if (s.RN2 % 4 || s.CLN2 % kQt) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // samples per CTA: a CTA of S samples takes about (S + 1) units of time
  // (74, 115 and 189 ms for S = 1, 2, 4 at default_128 on an H100), one CTA
  // runs per SM, so take the S that fits and minimises waves * (S + 1)
  int S = 0;
  long best = 0;
  for (int cand = 1; cand <= 4; cand *= 2) {
    if (layout(s, cand) > max_smem) break;
    const long waves = ((B + cand - 1) / cand + sms - 1) / sms;
    if (S == 0 || waves * (cand + 1) < best) S = cand, best = waves * (cand + 1);
  }
  if (S == 0) return static_cast<int>(cudaErrorInvalidValue);
  layout(s, S);
  info[0] = S;
  info[1] = kThreads;
  info[2] = s.smem;
  info[3] = (B + S - 1) / S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = key_limbs == 3 ? launch_s<3>(S, acc0, bk_lhs, a_hat, tables, out, s, st)
                       : launch_s<4>(S, acc0, bk_lhs, a_hat, tables, out, s, st);
  return static_cast<int>(err);
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
