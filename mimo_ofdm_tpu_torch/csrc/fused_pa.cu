// Fused OFDM transmit chain over rows of complex points:
//
//     out = FFT_ortho( PA( IFFT_ortho( in ) ) )
//
// Replaces the TPU kernel mimo_ofdm_tpu/kernels/fused_pa.py::fused_ifft_clip_fft
// (Pallas, body _fused_kernel) and, in its subcarrier mode, the XLA matmul
// chain that the JAX main path runs in its place,
// mimo_ofdm_tpu/ops/mxu_fft.py::fused_sc_ifft_pa_fft_planar_io.
//
// Two I/O modes of one kernel; only the load and store index maps differ:
//   full : read and write all n_fft bins (the Pallas kernel's contract).
//   sc   : read n_sc data bins in [neg | pos] order, scatter them into the
//          bin layout of ops/ofdm.py (DC and guard bins zero), and write back
//          only the data bins in the same order, bin n_sc/2 last.
//
// Four I/O layouts; only how one point is read and written differs (struct
// Planes, struct Interleaved), the index maps and the 1/sqrt(n) stay shared:
//   planes f32, planes bf16 : separate real and imag planes of that type;
//   interleaved f32         : complex64, one float2 a point (the Pallas
//                             kernel's own complex64 contract);
//   interleaved bf16        : complex64 whose two halves are rounded to bf16
//                             on load and on store, which gives the bits of
//                             bf16 planes cast from and back to complex64.
// A complex64 caller thus needs no copies into planes and back.
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores). Per canonical row (n_fft 4096, n_sc 2048, sc mode, bf16 planes) the
// kernel moves 16 KB (4.9 ns at 3.35 TB/s) and the two transforms need 0.33
// MFLOP (5.0 ns at 67 TFLOP/s; split-radix count less the zero and dropped
// bins, kernels/fused_pa.py::flops_per_row): bytes and operations bound it
// about equally. The f32 and interleaved layouts move 8 bytes a point each
// way, 32 KB a row: there the bytes bound it, twice over.
// In practice a transform that keeps its row on chip is held back by the
// traffic between threads (an SM's shared memory serves 128 bytes a clock;
// one pass through it per radix-4 stage moves about 1 MB a row, eight times
// what the arithmetic costs), by the instructions around the arithmetic,
// and by the wait for each row's input.
//
// What the design does about it:
//   * Registers hold the row. A row of n_fft = 16^2 * r points (r = 1, 2, 4,
//     8, 16) is n_fft/16 threads of 16 complex points each; a block is 256
//     threads, so it holds 256 / (n_fft/16) rows. Each pass is a DFT over a
//     thread's own registers: radix 16 (as 4 x 4, the +-i free), 16, then r.
//     The IFFT is decimation in frequency, the FFT its transpose.
//   * Between two passes the points change hands once through shared memory
//     (store 16, sync, load 16): two exchanges per transform at n_fft > 256,
//     one at 256, 64 KB of shared-memory traffic a row in all at 4096. Only
//     the first exchange of each transform crosses warps and needs
//     __syncthreads(); the second moves points among the R threads that
//     share one k, which sit in one warp, so __syncwarp() orders it. Two
//     buffers of 4096 float2 (64 KB, dynamic shared memory) alternate, so one
//     barrier per exchange is enough. The address swizzle
//     addr ^ ((addr >> 4) & 15) puts every half-warp's 16 accesses on 16
//     distinct 8-byte bank pairs, for every n_fft, read and write
//     (kernels/fused_pa.py::schedule holds the same addresses, and the CPU
//     tests count the bank conflicts from them).
//   * No permutation and no exchange around the PA: the last IFFT pass leaves
//     each thread 16 digit-reversed time samples, and the first FFT pass
//     (the last IFFT pass transposed) takes exactly those. The PA is
//     memoryless, so it runs on the registers in between. This is the
//     Pallas kernel's permutation cancellation, carried into registers.
//   * Loads and stores go straight between device memory and registers:
//     register j of thread t is bin t + (n_fft/16) j, so for each j a warp
//     touches consecutive bins (in the interleaved layouts one 8-byte float2
//     a thread, 256 contiguous bytes a warp). The sc maps and the ortho
//     1/sqrt(n_fft) are applied there. Each block first asks L2 for the
//     input of the block one wave later, so that block's loads wait on L2,
//     not on device memory.
//   * Two resident blocks per SM (__launch_bounds__(256, 2), at most 128
//     registers a thread, no spills). Three would need 80 registers, and
//     ptxas then spills.
//   * Twiddles are a host-built table, computed in float64 and rounded to
//     f32, laid out in the order the threads read it (a warp reads one
//     contiguous run per register); no hardware sine approximations, since
//     the f32 mode is held to 1e-5 against an exact transform.
//
// Later work (not here): fusing the precode and antenna combine around the
// chain, and pruning the passes to the occupied bins.

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;                    // threads per block
constexpr int kPoints = 16;                      // complex points per thread
constexpr int kBlockPoints = kThreads * kPoints; // one exchange buffer (float2)
constexpr int kSmemBytes = 2 * kBlockPoints * static_cast<int>(sizeof(float2));
constexpr int kMinBlocks = 2;                    // resident blocks per SM to aim for

enum PaModel { kSoftlim = 0, kRapp = 1, kToi = 2, kNone = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to bf16 (nearest even, as torch casts) and widened back
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The I/O layouts. `Elem` is the element type of the arrays the kernel is
// handed, `kStreams` the number of arrays a side (the second is unused, and
// null, when it is 1); load() reads point i of a row as f32 and store()
// writes one, both before and after the shared 1/sqrt(n) scaling.
template <typename T>
struct Planes {   // real and imag planes of T
  using Elem = T;
  static constexpr int kStreams = 2;
  static __device__ __forceinline__ float2 load(const T* __restrict__ re,
                                                const T* __restrict__ im, int i) {
    return make_float2(to_f32(re[i]), to_f32(im[i]));
  }
  static __device__ __forceinline__ void store(T* __restrict__ re, T* __restrict__ im,
                                               int i, float2 v) {
    re[i] = from_f32<T>(v.x);
    im[i] = from_f32<T>(v.y);
  }
};

template <bool BF16>
struct Interleaved {   // complex64; with BF16 each half rounded to bf16 both ways
  using Elem = float2;
  static constexpr int kStreams = 1;
  static __device__ __forceinline__ float2 load(const float2* __restrict__ x,
                                                const float2*, int i) {
    const float2 v = x[i];
    return BF16 ? make_float2(bf16_round(v.x), bf16_round(v.y)) : v;
  }
  static __device__ __forceinline__ void store(float2* __restrict__ x, float2*, int i,
                                               float2 v) {
    x[i] = BF16 ? make_float2(bf16_round(v.x), bf16_round(v.y)) : v;
  }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// cos(2 pi m / 16), correctly rounded to f32
__host__ __device__ constexpr float cos16(int m) {
  constexpr float c1 = 0.923879532511286756f;   // cos(pi/8)
  constexpr float c2 = 0.707106781186547524f;   // cos(pi/4)
  constexpr float c3 = 0.382683432365089772f;   // cos(3 pi/8)
  switch (m & 15) {
    case 0: return 1.0f;
    case 1: return c1;
    case 2: return c2;
    case 3: return c3;
    case 4: return 0.0f;
    case 5: return -c3;
    case 6: return -c2;
    case 7: return -c1;
    case 8: return -1.0f;
    case 9: return -c1;
    case 10: return -c2;
    case 11: return -c3;
    case 12: return 0.0f;
    case 13: return c3;
    case 14: return c2;
    default: return c1;
  }
}

// v * exp(+-2 pi i M / 16): + for the inverse transform, - for the forward.
template <int M, bool INV>
__device__ __forceinline__ float2 rot16(float2 v) {
  constexpr int m = M & 15;
  if constexpr (m == 0) {
    return v;
  } else if constexpr (m == 4) {        // +i (inverse) or -i (forward)
    return INV ? make_float2(-v.y, v.x) : make_float2(v.y, -v.x);
  } else if constexpr (m == 8) {
    return make_float2(-v.x, -v.y);
  } else if constexpr (m == 12) {
    return INV ? make_float2(v.y, -v.x) : make_float2(-v.y, v.x);
  } else {
    constexpr float c = cos16(m);
    constexpr float s = INV ? cos16(m + 12) : -cos16(m + 12);   // +-sin
    return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
  }
}

__device__ __forceinline__ void dft2(float2& a0, float2& a1) {
  const float2 t = a1;
  a1 = make_float2(a0.x - t.x, a0.y - t.y);
  a0 = make_float2(a0.x + t.x, a0.y + t.y);
}

// In-place 4-point DFT, natural order in and out, with w4 = +i (inverse)
// or -i (forward).
template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = make_float2(a0.x + a2.x, a0.y + a2.y);
  const float2 t1 = make_float2(a0.x - a2.x, a0.y - a2.y);
  const float2 t2 = make_float2(a1.x + a3.x, a1.y + a3.y);
  const float2 t3 = make_float2(a1.x - a3.x, a1.y - a3.y);
  const float2 mt3 = rot16<4, INV>(t3);
  a0 = make_float2(t0.x + t2.x, t0.y + t2.y);
  a2 = make_float2(t0.x - t2.x, t0.y - t2.y);
  a1 = make_float2(t1.x + mt3.x, t1.y + mt3.y);
  a3 = make_float2(t1.x - mt3.x, t1.y - mt3.y);
}

__device__ __forceinline__ void swap2(float2& a, float2& b) {
  const float2 t = a;
  a = b;
  b = t;
}

// In-place 8-point DFT as 4 x 2: j = j1 + 2 j2, k = 4 k1 + k2.
template <bool INV>
__device__ __forceinline__ void dft8(float2* v) {
  dft4<INV>(v[0], v[2], v[4], v[6]);
  dft4<INV>(v[1], v[3], v[5], v[7]);
  v[3] = rot16<2, INV>(v[3]);
  v[5] = rot16<4, INV>(v[5]);
  v[7] = rot16<6, INV>(v[7]);
  dft2(v[0], v[1]);
  dft2(v[2], v[3]);
  dft2(v[4], v[5]);
  dft2(v[6], v[7]);
  // slot 2 k2 + k1 holds X[4 k1 + k2]
  float2 t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = v[i];
#pragma unroll
  for (int k1 = 0; k1 < 2; ++k1)
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) v[4 * k1 + k2] = t[2 * k2 + k1];
}

// In-place 16-point DFT as 4 x 4: j = j1 + 4 j2, k = 4 k1 + k2.
template <bool INV>
__device__ __forceinline__ void dft16(float2* v) {
  dft4<INV>(v[0], v[4], v[8], v[12]);
  dft4<INV>(v[1], v[5], v[9], v[13]);
  dft4<INV>(v[2], v[6], v[10], v[14]);
  dft4<INV>(v[3], v[7], v[11], v[15]);
  // slot j1 + 4 k2 times w16^(j1 k2)
  v[5] = rot16<1, INV>(v[5]);
  v[9] = rot16<2, INV>(v[9]);
  v[13] = rot16<3, INV>(v[13]);
  v[6] = rot16<2, INV>(v[6]);
  v[10] = rot16<4, INV>(v[10]);
  v[14] = rot16<6, INV>(v[14]);
  v[7] = rot16<3, INV>(v[7]);
  v[11] = rot16<6, INV>(v[11]);
  v[15] = rot16<9, INV>(v[15]);
  dft4<INV>(v[0], v[1], v[2], v[3]);
  dft4<INV>(v[4], v[5], v[6], v[7]);
  dft4<INV>(v[8], v[9], v[10], v[11]);
  dft4<INV>(v[12], v[13], v[14], v[15]);
  // slot 4 k2 + k1 holds X[4 k1 + k2]: transpose the 4 x 4
  swap2(v[1], v[4]);
  swap2(v[2], v[8]);
  swap2(v[3], v[12]);
  swap2(v[6], v[9]);
  swap2(v[7], v[13]);
  swap2(v[11], v[14]);
}

template <int R, bool INV>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) dft2(v[0], v[1]);
  else if constexpr (R == 4) dft4<INV>(v[0], v[1], v[2], v[3]);
  else if constexpr (R == 8) dft8<INV>(v);
  else dft16<INV>(v);
}

// Exchange-buffer bank swizzle, in float2 units.
__device__ __forceinline__ int swz(int addr) { return addr ^ ((addr >> 4) & 15); }

template <int MODEL>
__device__ __forceinline__ float pa_gain(float pwr, float sat, float coeff,
                                         float rapp_p, float rapp_exp) {
  if constexpr (MODEL == kSoftlim)
    return pwr <= sat ? 1.0f : sqrtf(sat / (pwr > 0.0f ? pwr : 1.0f));
  else if constexpr (MODEL == kRapp)
    return powf(1.0f + powf(pwr / sat, rapp_p), rapp_exp);
  else
    return 1.0f - coeff * pwr;   // kToi
}

// The PA on a thread's 16 samples, one model per launch: the switch over
// models sits outside the loop over samples.
template <int MODEL>
__device__ __forceinline__ void apply_pa(float2* v, float sat, float coeff,
                                         float rapp_p, float rapp_exp) {
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const float g = pa_gain<MODEL>(v[i].x * v[i].x + v[i].y * v[i].y, sat, coeff,
                                   rapp_p, rapp_exp);
    v[i] = make_float2(v[i].x * g, v[i].y * g);
  }
}

// One row per n_fft/16 threads. Thread t of a row: pass 1 as thread t
// (registers: bins t + TPR j in, k out); passes 2 and 3 as (k, a) =
// (t / R, t % R). Shared-memory addresses, before the swizzle, are those of
// kernels/fused_pa.py::schedule:
//   exchange 1: write k TPR + t (register k), read k TPR + a + R b (register b)
//   exchange 2: write k TPR + c R + a (register c), read
//               k TPR + (a (16/R) + cl) R + aa (register cl R + aa)
template <int LOG2N, bool SC, typename IO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_ifft_pa_fft_kernel(const typename IO::Elem* __restrict__ xr,
                         const typename IO::Elem* __restrict__ xi,
                         typename IO::Elem* __restrict__ outr,
                         typename IO::Elem* __restrict__ outi,
                         const float* __restrict__ sat,
                         const float* __restrict__ coeff,
                         const float2* __restrict__ tw, int rows, int n_io,
                         int pa_model, float rapp_p, float rapp_exp,
                         float norm, int ahead) {
  using T = typename IO::Elem;
  constexpr bool kTwo = IO::kStreams == 2;
  constexpr int N = 1 << LOG2N;
  constexpr int TPR = N / kPoints;     // threads per row
  constexpr int R = N / 256;           // radix of the third pass (1: none)
  constexpr int RPB = kThreads / TPR;  // rows per block
  static_assert(LOG2N >= 8 && LOG2N <= 12, "n_fft must be 256 .. 4096");

  extern __shared__ float2 smem[];
  const int slot = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * RPB + slot;
  const bool live = row < rows;
  float2* const buf_a = smem + slot * N;
  float2* const buf_b = smem + kBlockPoints + slot * N;
  const int k = t / R, a = t % R;
  const float2* __restrict__ tw1 = tw + t;                  // [k TPR] = W^(t k)
  const float2* __restrict__ tw2 = tw + kPoints * TPR + a;  // [c R] = W^(16 a c)
  const size_t off = live ? static_cast<size_t>(row) * n_io : 0;
  // Register j holds bin p = t + TPR j. It lies in the row at p (full
  // mode); in sc mode at p + h - 1 in the positive band 1 <= p <= h, at
  // p - (N - h) in the negative band p >= N - h, and nowhere for DC and the
  // guard band. The same index serves every layout.
  const int h = n_io >> 1;
  float2 v[kPoints];

  // Ask L2 for the rows of the block `ahead` blocks on (as many as the card
  // holds at once), which starts about when this one ends: its loads then
  // wait on L2, not on device memory.
  const long long next = (static_cast<long long>(blockIdx.x) + ahead) * RPB;
  if (next < rows) {
    const size_t bytes = static_cast<size_t>(min(static_cast<long long>(RPB), rows - next)) * n_io * sizeof(T);
    const char* nr = reinterpret_cast<const char*>(xr + next * n_io);
    [[maybe_unused]] const char* ni =
        kTwo ? reinterpret_cast<const char*>(xi + next * n_io) : nullptr;
    for (size_t b = threadIdx.x * 128; b < bytes; b += kThreads * 128) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(nr + b));
      if constexpr (kTwo) asm volatile("prefetch.global.L2 [%0];" ::"l"(ni + b));
    }
  }

  // load, with the IFFT's 1/sqrt(n) folded in
  const T* __restrict__ rr = xr + off;
  const T* __restrict__ ri = kTwo ? xi + off : nullptr;
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int p = t + TPR * j;
    v[j] = make_float2(0.0f, 0.0f);
    const int src = !SC ? p : (p >= 1 && p <= h) ? h + p - 1 : (p >= N - h ? p - (N - h) : -1);
    if (live && src >= 0) {
      const float2 u = IO::load(rr, ri, src);
      v[j] = make_float2(u.x * norm, u.y * norm);
    }
  }

  // IFFT pass 1: DFT-16 over j -> k, twiddle conj(W^(t k))
  dft16<true>(v);
#pragma unroll
  for (int i = 1; i < kPoints; ++i) v[i] = cmul_conj(v[i], __ldg(tw1 + i * TPR));
#pragma unroll
  for (int i = 0; i < kPoints; ++i) buf_a[swz(i * TPR + t)] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPoints; ++i) v[i] = buf_a[swz(k * TPR + a + R * i)];

  // IFFT pass 2: DFT-16 over b -> c, twiddle conj(W^(16 a c))
  dft16<true>(v);
  if constexpr (R > 1) {
#pragma unroll
    for (int i = 1; i < kPoints; ++i) v[i] = cmul_conj(v[i], __ldg(tw2 + i * R));
#pragma unroll
    for (int i = 0; i < kPoints; ++i) buf_b[swz(k * TPR + i * R + a)] = v[i];
    __syncwarp();   // exchange 2 stays among the R threads of one k: one warp
#pragma unroll
    for (int i = 0; i < kPoints; ++i)
      v[i] = buf_b[swz(k * TPR + (a * (kPoints / R) + i / R) * R + i % R)];
    // IFFT pass 3: 16/R DFT-Rs over a -> c3
#pragma unroll
    for (int i = 0; i < kPoints; i += R) dft<R, true>(v + i);
  }

  // memoryless PA on the thread's 16 (digit-reversed) time samples
  const float s_row = live ? sat[row] : 1.0f;
  const float c_row = live ? coeff[row] : 0.0f;
  switch (pa_model) {
    case kSoftlim: apply_pa<kSoftlim>(v, s_row, c_row, rapp_p, rapp_exp); break;
    case kRapp: apply_pa<kRapp>(v, s_row, c_row, rapp_p, rapp_exp); break;
    case kToi: apply_pa<kToi>(v, s_row, c_row, rapp_p, rapp_exp); break;
    default: break;   // kNone
  }

  // FFT: the IFFT's passes transposed, in reverse order
  if constexpr (R > 1) {
#pragma unroll
    for (int i = 0; i < kPoints; i += R) dft<R, false>(v + i);
#pragma unroll
    for (int i = 0; i < kPoints; ++i)
      buf_a[swz(k * TPR + (a * (kPoints / R) + i / R) * R + i % R)] = v[i];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPoints; ++i) v[i] = buf_a[swz(k * TPR + i * R + a)];
#pragma unroll
    for (int i = 1; i < kPoints; ++i) v[i] = cmul(v[i], __ldg(tw2 + i * R));
  }
  dft16<false>(v);
#pragma unroll
  for (int i = 0; i < kPoints; ++i) buf_b[swz(k * TPR + a + R * i)] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPoints; ++i) v[i] = buf_b[swz(i * TPR + t)];
#pragma unroll
  for (int i = 1; i < kPoints; ++i) v[i] = cmul(v[i], __ldg(tw1 + i * TPR));
  dft16<false>(v);

  // store, with the FFT's 1/sqrt(n) folded in
  if (!live) return;
  T* __restrict__ wr = outr + off;
  T* __restrict__ wi = kTwo ? outi + off : nullptr;
  // h again, hidden from the compiler: otherwise it keeps the 16 load
  // indices live through both transforms to reuse them here, which costs
  // registers and, at two resident blocks per SM, time
  int hs;
  asm volatile("mov.b32 %0, %1;" : "=r"(hs) : "r"(h));
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int p = t + TPR * j;
    const int dst = !SC ? p : (p >= 1 && p <= hs) ? hs + p - 1 : (p >= N - hs ? p - (N - hs) : -1);
    if (dst >= 0) IO::store(wr, wi, dst, make_float2(v[j].x * norm, v[j].y * norm));
  }
}

// Sets one instantiation up on the current device, once per device (the
// calls cost microseconds of host time): lets it take kSmemBytes of dynamic
// shared memory, and writes how many of its blocks the card holds at once.
template <int LOG2N, bool SC, typename IO>
int setup(int* resident) {
  static std::atomic<int> cache[64];   // per device; 0 until set up
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = cache[dev & 63].load(std::memory_order_relaxed);
  if (*resident) return 0;
  auto kern = fused_ifft_pa_fft_kernel<LOG2N, SC, IO>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = per_sm * sms > 0 ? per_sm * sms : 1;
  cache[dev & 63].store(*resident, std::memory_order_relaxed);
  return 0;
}

struct LaunchArgs {
  const void *xr, *xi;
  void *outr, *outi;
  const float *sat, *coeff;
  const float2* tw;
  int rows, n_io, pa_model;
  float rapp_p, rapp_exp, norm;
  cudaStream_t stream;

  template <int LOG2N, bool SC, typename IO>
  int run() const {
    using T = typename IO::Elem;
    int resident = 0;
    if (const int err = setup<LOG2N, SC, IO>(&resident)) return err;
    constexpr int rpb = kThreads / ((1 << LOG2N) / kPoints);
    const int blocks = (rows + rpb - 1) / rpb;
    fused_ifft_pa_fft_kernel<LOG2N, SC, IO><<<blocks, kThreads, kSmemBytes, stream>>>(
        static_cast<const T*>(xr), static_cast<const T*>(xi),
        static_cast<T*>(outr), static_cast<T*>(outi), sat, coeff, tw, rows, n_io,
        pa_model, rapp_p, rapp_exp, norm, resident);
    return static_cast<int>(cudaGetLastError());
  }
};

// registers, local bytes (spills and stack), static and dynamic shared
// memory, resident blocks per SM
struct AttributesArgs {
  int* out;

  template <int LOG2N, bool SC, typename IO>
  int run() const {
    auto kern = fused_ifft_pa_fft_kernel<LOG2N, SC, IO>;
    int resident = 0;
    if (const int e = setup<LOG2N, SC, IO>(&resident)) return e;
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.localSizeBytes);
    out[2] = static_cast<int>(fa.sharedSizeBytes);
    out[3] = kSmemBytes;
    out[4] = blocks;
    return 0;
  }
};

template <bool SC, typename IO, typename Op>
int by_size(const Op& op, int log2n) {
  switch (log2n) {
    case 8: return op.template run<8, SC, IO>();
    case 9: return op.template run<9, SC, IO>();
    case 10: return op.template run<10, SC, IO>();
    case 11: return op.template run<11, SC, IO>();
    case 12: return op.template run<12, SC, IO>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename IO, typename Op>
int by_mode(const Op& op, int log2n, int sc_mode) {
  return sc_mode ? by_size<true, IO>(op, log2n) : by_size<false, IO>(op, log2n);
}

// 5 sizes x 2 modes x 4 layouts: 40 instantiations
template <typename Op>
int dispatch(const Op& op, int log2n, int sc_mode, int bf16, int interleaved) {
  if (interleaved)
    return bf16 ? by_mode<Interleaved<true>>(op, log2n, sc_mode)
                : by_mode<Interleaved<false>>(op, log2n, sc_mode);
  return bf16 ? by_mode<Planes<__nv_bfloat16>>(op, log2n, sc_mode)
              : by_mode<Planes<float>>(op, log2n, sc_mode);
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of contiguous
// tensors: real and imag planes (float or bf16 by `bf16`), or with
// `interleaved` one complex64 array a side in xr/outr (xi, outi null), its
// halves rounded to bf16 on load and store when `bf16` is set. `tw` is
// kernels/fused_pa.py::twiddle_table(n_fft) on the device; `stream` is the
// cudaStream_t of the caller's current stream. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fused_ifft_pa_fft_launch(const void* xr, const void* xi,
                                        void* outr, void* outi,
                                        const float* sat, const float* coeff,
                                        const void* tw, int rows, int log2n,
                                        int n_io, int sc_mode, int bf16,
                                        int interleaved, int pa_model,
                                        float rapp_p, float rapp_exp,
                                        float norm, void* stream) {
  if (rows <= 0) return 0;
  const LaunchArgs args{xr, xi, outr, outi, sat, coeff,
                        static_cast<const float2*>(tw), rows, n_io, pa_model,
                        rapp_p, rapp_exp, norm, static_cast<cudaStream_t>(stream)};
  return dispatch(args, log2n, sc_mode, bf16, interleaved);
}

// Resources of one instantiation, written to out[0..4]: registers a thread,
// local memory bytes a thread, static and dynamic shared memory bytes a
// block, resident blocks per SM. Returns a CUDA error code (0 on success).
extern "C" int fused_ifft_pa_fft_attributes(int log2n, int sc_mode, int bf16,
                                            int interleaved, int* out) {
  return dispatch(AttributesArgs{out}, log2n, sc_mode, bf16, interleaved);
}
