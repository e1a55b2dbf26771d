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
// Eight I/O layouts; only how one point is read and written differs (struct
// Planes, Interleaved, Precoded, PrecodedMu), the index maps and the
// 1/sqrt(n) stay shared:
//   planes f32, planes bf16 : separate real and imag planes of that type;
//   interleaved f32         : complex64, one float2 a point (the Pallas
//                             kernel's own complex64 contract);
//   interleaved bf16        : complex64 whose two halves are rounded to bf16
//                             on load and on store, which gives the bits of
//                             bf16 planes cast from and back to complex64;
//   precoded f32, precoded bf16 (sc mode only): the single-user MRT precode
//                             P = s o V on load, from a frame's complex64
//                             symbols s and the planes of its precoder V,
//                             row (b, ant) reading s[b] and V[b, ant], with
//                             the roundings of the eager precode; the store
//                             is that of the planes;
//   precoded_mu f32, precoded_mu bf16 (sc mode only): the multi-user joint
//                             precode sum_u s_u o V_u on load, from the
//                             frames' complex64 symbols of every user (in an
//                             MCNC-MU replica pass one user's swapped for its
//                             detection) and the complex64 precoder V, with
//                             the roundings of the eager precode and user
//                             sum; the store is the interleaved one.
// A complex64 caller thus needs no copies into planes and back, and the
// transmitters' precoded planes and sums are never written.
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
// The two bf16 layouts have a design of their own, on the tensor cores
// (fused_ifft_pa_fft_tc_kernel below): the JAX chain's bf16 contract, which
// the TPU runs on its matrix unit (mimo_ofdm_tpu/ops/mxu_fft.py:375-384),
// run here as bf16 matrix products with f32 accumulation. The f32 layouts
// keep the CUDA-core kernel above, since bf16 operands would break their
// 1e-5 tolerance.
//
// Later work (not here): fusing the antenna combine after the chain, and
// pruning the passes to the occupied bins.

#include <atomic>
#include <cstdint>
#include <type_traits>

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

// lo into the low half, hi into the high half, each rounded to bf16
// (nearest even, as torch casts)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Two bf16 lanes at once, each rounded to nearest even: a * b, a + b, a - b.
// Explicitly .rn, so never contracted into an FMA. For bf16 operands each
// equals the f32 operation rounded to bf16, as torch's bf16 operations
// compute it: f32 holds 24 bits, at least 2 * 8 + 2, so rounding twice
// gives what rounding once does.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The I/O layouts. `Elem` is the element type of the arrays the kernel is
// handed, `kStreams` the number of arrays a side (the second is unused, and
// null, when it is 1); `Args` is what the layout reads beside those arrays
// (a kernel argument), `at(args, row, n_io)` its part for one row; load()
// reads point i of a row as f32 and store() writes one, both before and
// after the shared 1/sqrt(n) scaling. A layout with kPairs gives the
// tensor-core kernel two points at once as its bf16 A operand instead
// (load_pair); one with kSummed sums its points over users, and orders the
// rows and their prefetch itself (PrecodedMu). `args(launch)` takes the
// layout's part of the launch's arguments (LaunchArgs).
struct Alone {   // a layout that reads nothing beside its arrays
  static constexpr bool kPairs = false;
  static constexpr bool kSummed = false;
  struct Args {};
  template <typename L> static Args args(const L&) { return {}; }
  static __device__ __forceinline__ Args at(Args, long long, int) { return {}; }
};

template <typename T>
struct Planes : Alone {   // real and imag planes of T
  using Elem = T;
  static constexpr int kStreams = 2;
  static __device__ __forceinline__ float2 load(const T* __restrict__ re,
                                                const T* __restrict__ im, Args, int i) {
    return make_float2(to_f32(re[i]), to_f32(im[i]));
  }
  static __device__ __forceinline__ void store(T* __restrict__ re, T* __restrict__ im,
                                               int i, float2 v) {
    re[i] = from_f32<T>(v.x);
    im[i] = from_f32<T>(v.y);
  }
};

template <bool BF16>
struct Interleaved : Alone {   // complex64; with BF16 each half rounded to bf16 both ways
  using Elem = float2;
  static constexpr int kStreams = 1;
  static __device__ __forceinline__ float2 load(const float2* __restrict__ x,
                                                const float2*, Args, int i) {
    const float2 v = x[i];
    return BF16 ? make_float2(bf16_round(v.x), bf16_round(v.y)) : v;
  }
  static __device__ __forceinline__ void store(float2* __restrict__ x, float2*, int i,
                                               float2 v) {
    x[i] = BF16 ? make_float2(bf16_round(v.x), bf16_round(v.y)) : v;
  }
};

// The MRT precode of the transmitter as the load: the arrays are the planes
// of the precoder V [frames x n_ant rows, n_io] in T, `Args` the frames'
// complex64 symbols s [frames, n_io] and n_ant; row r reads s[r / n_ant],
// which its n_ant rows share from L2. Point i gives s o V exactly as the
// eager precode stores it (kernels/fused_pa.py::precode_planes): s's halves
// cast to T, then each product, difference and sum one operation of T
// rounded to nearest, never contracted into an FMA. In f32 that is load();
// the bf16 planes run on the tensor cores, which take two points at once
// (load_pair).
template <typename T>
struct Precoded : Planes<T> {
  static constexpr bool kPairs = std::is_same_v<T, __nv_bfloat16>;
  struct Args {
    const float2* s;
    int n_ant;
  };
  template <typename L> static Args args(const L& l) { return {l.sym, l.n_ant}; }
  static __device__ __forceinline__ const float2* at(Args a, long long row, int n_io) {
    return a.s + static_cast<size_t>(static_cast<int>(row) / a.n_ant) * n_io;
  }
  static __device__ __forceinline__ float2 load(const T* __restrict__ vr,
                                                const T* __restrict__ vi,
                                                const float2* __restrict__ s, int i) {
    static_assert(std::is_same_v<T, float>, "bf16 planes take load_pair");
    const float2 x = __ldg(s + i);
    return make_float2(__fsub_rn(__fmul_rn(x.x, vr[i]), __fmul_rn(x.y, vi[i])),
                       __fadd_rn(__fmul_rn(x.x, vi[i]), __fmul_rn(x.y, vr[i])));
  }
  // bf16: points a and b (-1: none, which reads 0) as the low and high
  // halves of the real and imag bf16x2 operands of a tile, s's halves
  // rounded to bf16 (pack) and each operation in bf16x2
  static __device__ __forceinline__ void load_pair(const T* __restrict__ vr,
                                                   const T* __restrict__ vi,
                                                   const float2* __restrict__ s, int a,
                                                   int b, uint32_t& re, uint32_t& im) {
    const auto* __restrict__ hr = reinterpret_cast<const unsigned short*>(vr);
    const auto* __restrict__ hi = reinterpret_cast<const unsigned short*>(vi);
    const float2 zero = make_float2(0.0f, 0.0f);
    const float2 sa = a >= 0 ? __ldg(s + a) : zero, sb = b >= 0 ? __ldg(s + b) : zero;
    const uint32_t v_r = (a >= 0 ? hr[a] : 0u) | (b >= 0 ? hr[b] : 0u) << 16;
    const uint32_t v_i = (a >= 0 ? hi[a] : 0u) | (b >= 0 ? hi[b] : 0u) << 16;
    const uint32_t sr = pack(sa.x, sb.x), si = pack(sa.y, sb.y);
    re = sub_bf16x2(mul_bf16x2(sr, v_r), mul_bf16x2(si, v_i));
    im = add_bf16x2(mul_bf16x2(sr, v_i), mul_bf16x2(si, v_r));
  }
};

// The multi-user joint precode of the transmitter as the load: point i of a
// row is sum_u s_u[i] V[b, ant, u, i] over the n_usr users, from the
// complex64 precoder V [frames, n_ant, n_usr, n_io] (any strides but the
// last; `Args`'s v and its strides) and the users' complex64 symbols
// usr [frames, n_usr, n_io]. The arrays handed to the kernel are V (xr, for
// the prefetch) and the complex64 output, stored as the interleaved layout
// stores (BF16: each half rounded to bf16).
//   * The rows are [frames, n_ant] (the transmitter), or with the
//     detections det [n_rep = n_usr, frames, n_io] (an MCNC-MU replica
//     pass) [n_usr, frames, n_ant]: row (r, b, ant) reads user r's symbols
//     from det[r, b] and every other user's from usr[b], the torch.where
//     swap of the eager replica.
//   * Each term and the sum are what the eager route stores
//     (kernels/fused_pa.py::precode_users): ATen's complex64 product
//     (a + ib)(c + id), which the card's build of ATen computes as
//     fma(a, c, -(b d)) + i fma(a, d, b c), then the terms added to 0 in
//     user order, as ATen's sum over up to 4 users adds them; each
//     operation pinned (__fmaf_rn, __fmul_rn, __fadd_rn). The load then
//     rounds each half where Interleaved<BF16> rounds its input.
//   * Blocks take the rows with the user of the detection running fastest
//     (output_row): the rows (0, b, ant) and (1, b, ant), which read the
//     same V[b, ant], run side by side, so the second read of V's 32 KB
//     hits L2.
template <bool BF16>
struct PrecodedMu : Interleaved<BF16> {
  static constexpr bool kSummed = true;
  struct Args {
    const float2* v;
    long long frame_stride, ant_stride, user_stride;   // V's, in complex points
    const float2* usr;
    const float2* det;                                  // null: no swap
    int n_ant, n_usr, n_rep, frames;
  };
  template <typename L> static Args args(const L& l) {
    const int n_rep = l.det ? l.n_usr : 1;
    return {static_cast<const float2*>(l.xr), l.v_strides[0], l.v_strides[1],
            l.v_strides[2], l.sym, l.det, l.n_ant, l.n_usr, n_rep,
            l.rows / (n_rep * l.n_ant)};
  }
  // a row: its frame, antenna and swapped user (the pointers are made
  // from them and the kernel's arguments when read, which holds 3
  // registers a row through the loads, not 9)
  struct Row {
    int b, ant, r;
  };
  // (the rows, as the launch's `rows`, fit an int)
  static __device__ __forceinline__ Row at(Args a, long long row, int) {
    const int vrows = a.frames * a.n_ant;
    const int r = static_cast<int>(row) / vrows;
    const int vrow = static_cast<int>(row) - r * vrows;
    const int b = vrow / a.n_ant;
    return {b, vrow - b * a.n_ant, r};
  }
  // the output row that the block-order row `i` computes
  static __device__ __forceinline__ long long output_row(Args a, long long i) {
    const int k = static_cast<int>(i);
    return (k % a.n_rep) * (a.frames * a.n_ant) + k / a.n_rep;
  }
  // user u's symbols and precoder of a row
  static __device__ __forceinline__ const float2* symbols(Args a, Row w, int u, int n_io) {
    return a.det && u == w.r ? a.det + (static_cast<size_t>(w.r) * a.frames + w.b) * n_io
                             : a.usr + (static_cast<size_t>(w.b) * a.n_usr + u) * n_io;
  }
  static __device__ __forceinline__ const float2* precoder(Args a, Row w, int u) {
    return a.v + w.b * a.frame_stride + w.ant * a.ant_stride + u * a.user_stride;
  }
  // point i (-1: none, which reads 0) of a user's symbols or precoder: a
  // select, not a branch, so that a user's loads all issue before the
  // first sum waits on them
  static __device__ __forceinline__ float2 point(const float2* __restrict__ x, int i) {
    return i >= 0 ? __ldg(x + i) : make_float2(0.0f, 0.0f);
  }
  // acc + s v, as the eager route stores the product and adds it; a point
  // outside the row reads s = v = 0 and keeps acc at +0
  static __device__ __forceinline__ float2 add_term(float2 acc, float2 s, float2 v) {
    const float re = __fmaf_rn(s.x, v.x, -__fmul_rn(s.y, v.y));
    const float im = __fmaf_rn(s.x, v.y, __fmul_rn(s.y, v.x));
    return make_float2(__fadd_rn(acc.x, re), __fadd_rn(acc.y, im));
  }
  // into L2: every user's V row of the `count` block-order rows from `first`
  static __device__ __forceinline__ void prefetch(Args a, long long first, int count,
                                                  int n_io) {
    const int lines = (n_io * static_cast<int>(sizeof(float2)) + 127) / 128;
    const int total = count * a.n_usr * lines;
    for (int k = threadIdx.x; k < total; k += kThreads) {
      const int l = k / lines, line = k - l * lines;
      const int i = l / a.n_usr, u = l - i * a.n_usr;
      const Row w = at(a, output_row(a, first + i), n_io);
      const char* p = reinterpret_cast<const char*>(precoder(a, w, u)) + 128 * line;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    }
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
                         float norm, int ahead, typename IO::Args io_args) {
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
  long long row = static_cast<long long>(blockIdx.x) * RPB + slot;
  const bool live = row < rows;
  if constexpr (IO::kSummed) {
    if (live) row = IO::output_row(io_args, row);
  }
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
    if constexpr (IO::kSummed) {
      IO::prefetch(io_args, next, static_cast<int>(min(static_cast<long long>(RPB), rows - next)),
                   n_io);
    } else {
      const size_t bytes = static_cast<size_t>(min(static_cast<long long>(RPB), rows - next)) * n_io * sizeof(T);
      const char* nr = reinterpret_cast<const char*>(xr + next * n_io);
      [[maybe_unused]] const char* ni =
          kTwo ? reinterpret_cast<const char*>(xi + next * n_io) : nullptr;
      for (size_t b = threadIdx.x * 128; b < bytes; b += kThreads * 128) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(nr + b));
        if constexpr (kTwo) asm volatile("prefetch.global.L2 [%0];" ::"l"(ni + b));
      }
    }
  }

  // load, with the IFFT's 1/sqrt(n) folded in
  if constexpr (IO::kSummed) {
    // one user's points at a time; the 1/sqrt(n) a rounded product of its
    // own, as the interleaved layout scales its load
    const auto w = IO::at(io_args, live ? row : 0, n_io);
#pragma unroll
    for (int j = 0; j < kPoints; ++j) v[j] = make_float2(0.0f, 0.0f);
    for (int u = 0; u < io_args.n_usr; ++u) {
      const float2* __restrict__ s = IO::symbols(io_args, w, u, n_io);
      const float2* __restrict__ pv = IO::precoder(io_args, w, u);
#pragma unroll
      for (int j = 0; j < kPoints; ++j) {
        const int p = t + TPR * j;
        const int bin = !SC ? p : (p >= 1 && p <= h) ? h + p - 1 : (p >= N - h ? p - (N - h) : -1);
        const int src = live ? bin : -1;
        v[j] = IO::add_term(v[j], IO::point(s, src), IO::point(pv, src));
      }
    }
#pragma unroll
    for (int j = 0; j < kPoints; ++j)
      v[j] = make_float2(__fmul_rn(v[j].x, norm), __fmul_rn(v[j].y, norm));
  } else {
    const T* __restrict__ rr = xr + off;
    const T* __restrict__ ri = kTwo ? xi + off : nullptr;
    const auto at = IO::at(io_args, live ? row : 0, n_io);
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      const int p = t + TPR * j;
      v[j] = make_float2(0.0f, 0.0f);
      const int src = !SC ? p : (p >= 1 && p <= h) ? h + p - 1 : (p >= N - h ? p - (N - h) : -1);
      if (live && src >= 0) {
        const float2 u = IO::load(rr, ri, at, src);
        v[j] = make_float2(u.x * norm, u.y * norm);
      }
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

// ---------------------------------------------------------------------------
// The bf16 layouts on the tensor cores.
//
// What bounds the CUDA-core kernel above in bf16 is its instructions: at
// [32768, 2048] (sc, bf16 planes) it takes about 8,000 cycles of an SM a
// row against 1,300 of f32 FMA slots, most of them the butterflies' adds,
// the twiddles and the exchanges. Here each radix-16 pass is bf16 products
// on the tensor cores, mma.sync m16n8k16 with f32 accumulation, which is
// the JAX chain's bf16 contract (bf16 DFT tables, single-pass products,
// f32 sums) on this card's matrix unit:
//   * A row of N = 16 * 16 * R points is R tiles of 16 x 16 points, and
//     each pass is one product a tile: 16 columns (the tile's rows, the A
//     operand) of 16 points times a DFT-16 matrix (B, held in registers
//     for the whole kernel). The passes are those of the CUDA-core kernel:
//     radix 16 over the bins t + N/16 j, radix 16 over t's top digit, then
//     radix R, here as a block-diagonal 16 x 16 matrix of DFT-Rs (R < 16)
//     so that every pass is one product shape.
//   * The complex product is one real product with K = 32, [Re | Im] of
//     the input against [[C, +-S], [-+S, C]]: 8 mma a tile, no Karatsuba
//     combines, whose every sum would be one more bf16 rounding. About 128
//     flops a point a pass: 3.1 MFLOP a 4096-point row, 0.10 ms for 32,768
//     rows at 989 TFLOP/s dense bf16, under the 0.16 ms of their bytes.
//   * Rounding to bf16 only where an operand of a product needs it: each
//     pass's f32 accumulators take their twiddle (and on pass 1 the ortho
//     1/sqrt(N), folded into the table), or the PA, in f32 on the CUDA
//     cores, and are rounded once, as the next pass's operand.
//   * The accumulator layout of m16n8k16 over two n-tiles is its A layout,
//     so the PA between the last IFFT pass and the first FFT pass (the same
//     columns, transposed) needs no exchange: the permutation cancellation
//     again. Between the other passes a tile goes through shared memory as
//     bf16 planes in 16-byte chunks of 8 points: stmatrix from the
//     accumulators, ldmatrix (.trans on one side) into the next operand,
//     4 instructions a tile each way. The chunk index u is swizzled as
//     u ^ (xor of u's 3-bit digits above the lowest) & 7: every 8x8 matrix
//     of either side changes exactly three consecutive bits of u, which then
//     land on 8 distinct 16-byte bank groups (kernels/fused_pa.py::
//     tensor_schedule holds the same addresses; the CPU tests count them).
//   * A warp holds 2 tiles, a block 16 (16 / R rows); two buffers of 16 KB
//     alternate, one barrier an exchange (__syncwarp where a row's tiles
//     are one warp's, R <= 2).
//   * Loads and stores go between device memory and the operand or
//     accumulator registers directly (a warp touches 4 runs of 8
//     consecutive bins per register), with the sc maps and the L2 prefetch
//     of the kernel above. The precoded layout forms each operand register
//     (two points) from the symbols and V by bf16x2 products and a
//     difference or sum (Precoded::load_pair): 0.94 ms at [32768, 2048]
//     against the planes' 0.79, most of the difference the symbols' 8 B a
//     point from L2, and 1.80 for the eager precode and the planes' launch
//     it replaces; the same precode in f32 a point took 1.31 ms (NVIDIA
//     H100 80GB HBM3, 700 W). The precoded_mu layout sums the users' s V
//     in f32 a point, one user's loads at a time as selects, not branches:
//     0.618 ms at [16384, 2048] (an MCNC-MU replica pass) against the
//     interleaved layout's 0.406, and 1.078 for the eager swap, precode
//     and interleaved launch it replaces; most of the difference is its
//     reads from L2, 32 B a point (both users' symbols and V) against 8.
//     With the loads as branches it took 1.109 ms, each point's loads
//     waiting on the one before (same card).
//   * Twiddles and the DFT matrices' B fragments come from one host-built
//     table (kernels/fused_pa.py::tensor_kernel_table) laid out in the
//     order a warp's lanes read it, 256 contiguous bytes a load; a table
//     in natural order cost 8-32 sectors a load. The soft limiter's gain
//     is sqrt(sat) * rsqrt(pwr), since its output is rounded to bf16 next.
// Where it stands (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): about
// 0.80 ms at [32768, 2048], 0.20 of the bound, 17% under the CUDA-core
// kernel. The tensor cores take about an eighth of that; the rest is issue
// at a low IPC with 16 warps an SM (123-128 registers), through the chain
// of loads, five barrier-separated phases and stores: clock64 stamps put
// a third of a block's time in its loads, a fifth in its stores.
namespace tc {

constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 2;                          // 16 x 16 tiles a warp holds
constexpr int kBlockTiles = kWarps * kTiles;       // 4096 points a block
constexpr int kBufBytes = kBlockTiles * 256 * 4;   // one exchange buffer, bf16 re and im
constexpr int kSmemBytes = 2 * kBufBytes;

// A tile as the A operand: re and im as bf16x2 registers a0..a3 (row g +
// 8 (i & 1), points 2q + 8 (i >> 1) and one on), g = lane / 4, q = lane % 4.
struct Frag {
  uint32_t re[4], im[4];
};

// A tile of f32 accumulators: [n half h][c register e] at row g + 8 (e >> 1),
// point 8 h + 2 q + (e & 1).
struct Acc {
  float re[2][4], im[2][4];
};

// B fragments of a 16 x 16 DFT matrix C + i s S: cos, sin and -sin parts,
// [n half][register]; the lane holds rows 2q, 2q+1 (register 0), 2q+8,
// 2q+9 (register 1) of column 8 h + g.
struct Mat {
  uint32_t c[2][2], s[2][2], ns[2][2];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A DFT matrix's B fragments from the host-built table
// (kernels/fused_pa.py::tensor_kernel_table): words [c[h][r], s[h][r]] x
// lane, each a bf16 pair.
__device__ __forceinline__ Mat load_matrix(const float2* __restrict__ table) {
  const uint32_t* __restrict__ w =
      reinterpret_cast<const uint32_t*>(table) + (threadIdx.x & 31);
  Mat m;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m.c[h][r] = __ldg(w + (2 * h + r) * 32);
      m.s[h][r] = __ldg(w + (4 + 2 * h + r) * 32);
      m.ns[h][r] = m.s[h][r] ^ 0x80008000u;
    }
  return m;
}

// y = x M over a tile, M = C + i S (inverse) or C - i S (forward):
// Re y = Re x C -+ Im x S, Im y = +-Re x S + Im x C.
template <bool INV>
__device__ __forceinline__ void tile_dft(const Frag& x, const Mat& m, Acc& y) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) y.re[h][e] = y.im[h][e] = 0.0f;
    mma(y.re[h], x.re, m.c[h]);
    mma(y.re[h], x.im, INV ? m.ns[h] : m.s[h]);
    mma(y.im[h], x.re, INV ? m.s[h] : m.ns[h]);
    mma(y.im[h], x.im, m.c[h]);
  }
}

// The accumulators rounded to bf16 as the next product's A operand.
__device__ __forceinline__ Frag round_frag(const Acc& y) {
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = i >> 1, e = 2 * (i & 1);
    f.re[i] = pack(y.re[h][e], y.re[h][e + 1]);
    f.im[i] = pack(y.im[h][e], y.im[h][e + 1]);
  }
  return f;
}

// y times a twiddle a point (CONJ: its conjugate), in f32. `tw` is this
// tile's section of a lane-ordered table at the lane: the twiddle of Acc
// element (h, e) lies at tw[32 (4 h + e)], or with TWO_ROWS (the twiddle
// does not depend on the row) at tw[32 (2 h + e % 2)]. A warp reads 256
// contiguous bytes a load.
template <bool CONJ, bool TWO_ROWS = false>
__device__ __forceinline__ void twiddle(Acc& y, const float2* __restrict__ tw) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 w = __ldg(tw + 32 * (TWO_ROWS ? 2 * h + (e & 1) : 4 * h + e));
      const float wi = CONJ ? -w.y : w.y;
      const float yr = y.re[h][e], yi = y.im[h][e];
      y.re[h][e] = yr * w.x - yi * wi;
      y.im[h][e] = yr * wi + yi * w.x;
    }
}

// The PA on a tile of time samples, with the hardware's approximations
// (a few ulp), since its output is rounded to bf16 next: the soft
// limiter's gain as sqrt(sat) * rsqrt(pwr), Rapp's powers as __powf. The
// IEEE division and powf of pa_gain would put some two thousand
// instructions of rarely taken paths into every instantiation, which cost
// the soft limiter 14% of its time in the instruction cache.
template <int MODEL>
__device__ __forceinline__ void pa_tile(Acc& y, float sat, float coeff, float rapp_p,
                                        float rapp_exp) {
  [[maybe_unused]] const float root = MODEL == kSoftlim ? sqrtf(sat) : 0.0f;
  [[maybe_unused]] const float inv_sat = MODEL == kRapp ? __fdividef(1.0f, sat) : 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float re = y.re[h][e], im = y.im[h][e];
      const float pwr = re * re + im * im;
      float gain;
      if constexpr (MODEL == kSoftlim) gain = pwr <= sat ? 1.0f : root * rsqrtf(pwr);
      else if constexpr (MODEL == kRapp)
        gain = __powf(1.0f + __powf(pwr * inv_sat, rapp_p), rapp_exp);
      else gain = 1.0f - coeff * pwr;   // kToi
      y.re[h][e] = re * gain;
      y.im[h][e] = im * gain;
    }
}

__device__ __forceinline__ void pa(Acc& y, int model, float sat, float coeff, float rapp_p,
                                   float rapp_exp) {
  switch (model) {
    case kSoftlim: pa_tile<kSoftlim>(y, sat, coeff, rapp_p, rapp_exp); break;
    case kRapp: pa_tile<kRapp>(y, sat, coeff, rapp_p, rapp_exp); break;
    case kToi: pa_tile<kToi>(y, sat, coeff, rapp_p, rapp_exp); break;
    default: break;   // kNone
  }
}

// 16-byte chunk u of a row's plane -> its place: u's low 3 bits (the bank
// group) xor its higher 3-bit digits.
__device__ __forceinline__ uint32_t chunk_swizzle(int u) {
  const int v = u >> 3;
  return static_cast<uint32_t>(u ^ ((v ^ (v >> 3) ^ (v >> 6)) & 7));
}

// One tile to or from an exchange buffer: `re` is the byte address of the
// row's real plane (the imag plane follows N bf16 on), `u` the chunk this
// lane addresses. Without TRANS a chunk is 8 consecutive points of one row
// of the tile; with TRANS, 8 consecutive rows of one point.
template <bool TRANS, int N>
__device__ __forceinline__ void to_smem(uint32_t re, int u, const Frag& f) {
  const uint32_t a = re + 16 * chunk_swizzle(u);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t* r = p ? f.im : f.re;
    if constexpr (TRANS)
      asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
                   ::"r"(a + p * 2 * N), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
                   : "memory");
    else
      asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
                   ::"r"(a + p * 2 * N), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
                   : "memory");
  }
}

template <bool TRANS, int N>
__device__ __forceinline__ void from_smem(uint32_t re, int u, Frag& f) {
  const uint32_t a = re + 16 * chunk_swizzle(u);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t* r = p ? f.im : f.re;
    if constexpr (TRANS)
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                   : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                   : "r"(a + p * 2 * N) : "memory");
    else
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                   : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                   : "r"(a + p * 2 * N) : "memory");
  }
}

// A row's tiles lie in one warp when R <= kTiles.
template <int R>
__device__ __forceinline__ void exchange_sync() {
  if constexpr (R > kTiles) __syncthreads();
  else __syncwarp();
}

template <bool SC, int N>
__device__ __forceinline__ int io_index(int p, int h) {
  return !SC ? p : (p >= 1 && p <= h) ? h + p - 1 : (p >= N - h ? p - (N - h) : -1);
}

}  // namespace tc

// One block: 8 warps of 2 tiles, 16 / R rows. Warp w holds the block's
// tiles 2w and 2w + 1; tile b is tile tau = b % R of row slot b / R. The
// passes' tiles and the exchanges' chunks u (before the swizzle), for a
// lane's row-side coordinates (rm, rh) = (lane % 8 + 8 (lane / 8 % 2),
// lane / 16) and column-side ones (ck, cm) = (lane % 8 + 8 (lane / 16),
// lane / 8 % 2), as kernels/fused_pa.py::tensor_schedule holds them:
//   pass 1  tile tau: columns t = 16 tau + m, points j (bins t + N/16 j)
//   E1      row side 2 (16 tau + rm) + rh, column side 2 (a + R ck) + cm
//   pass 2  tile a:   columns (k, a) k = m, points b (t = a + R b)
//   E2      row side 2 (rm R + a) + rh, column side 2 (16 tau + ck) + cm
//   pass 3  tile tau: columns c = m, points (s, a), k = 16 tau / R + s
// The IFFT writes the row sides and reads the column sides, the FFT the
// other way round.
template <int LOG2N, bool SC, typename IO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_ifft_pa_fft_tc_kernel(const typename IO::Elem* __restrict__ xr,
                            const typename IO::Elem* __restrict__ xi,
                            typename IO::Elem* __restrict__ outr,
                            typename IO::Elem* __restrict__ outi,
                            const float* __restrict__ sat,
                            const float* __restrict__ coeff,
                            const float2* __restrict__ tw, int rows, int n_io,
                            int pa_model, float rapp_p, float rapp_exp,
                            float /* norm: in the twiddle table */, int ahead,
                            typename IO::Args io_args) {
  using namespace tc;
  using T = typename IO::Elem;
  constexpr bool kTwo = IO::kStreams == 2;
  constexpr int N = 1 << LOG2N;
  constexpr int TPR = N / kPoints;       // pass-1 columns of a row
  constexpr int R = N / 256;             // tiles a row; radix of pass 3 (1: none)
  constexpr int RPB = kBlockTiles / R;   // rows per block
  static_assert(LOG2N >= 8 && LOG2N <= 12, "n_fft must be 256 .. 4096");

  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int rm = (lane & 7) + 8 * ((lane >> 3) & 1), rh = lane >> 4;
  const int ck = (lane & 7) + 8 * (lane >> 4), cm = (lane >> 3) & 1;
  const uint32_t smem = static_cast<uint32_t>(__cvta_generic_to_shared(tc_smem));
  // kernels/fused_pa.py::tensor_kernel_table, lane-ordered: W^(t k) /
  // sqrt(N) after IFFT pass 1 [tile][8][lane], W^(16 a c) after IFFT pass
  // 2 [tile][4][lane] and after FFT pass 3 [8][lane], W^(t k) / sqrt(N)
  // after FFT pass 2 [tile][8][lane], then the B fragments of the DFT-16
  // and of the block-diagonal DFT-R
  const float2* __restrict__ tw1 = tw + lane;
  const float2* __restrict__ tw2 = tw1 + 256 * R;
  const float2* __restrict__ tw3 = tw2 + 128 * R;
  const float2* __restrict__ tw4 = tw3 + 256;
  const float2* __restrict__ mats = tw + 640 * R + 256;
  const int h = n_io >> 1;

  int tau[kTiles];
  long long row[kTiles];
  bool live[kTiles];
  uint32_t buf0[kTiles], buf1[kTiles];   // the row's real plane in each buffer
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int b = kTiles * warp + i;
    tau[i] = b % R;
    row[i] = static_cast<long long>(blockIdx.x) * RPB + b / R;
    live[i] = row[i] < rows;
    if constexpr (IO::kSummed) {
      if (live[i]) row[i] = IO::output_row(io_args, row[i]);
    }
    buf0[i] = smem + (b / R) * 4 * N;
    buf1[i] = buf0[i] + kBufBytes;
  }

  // the rows of the block `ahead` blocks on into L2, as the kernel above
  const long long next = (static_cast<long long>(blockIdx.x) + ahead) * RPB;
  if (next < rows) {
    if constexpr (IO::kSummed) {
      IO::prefetch(io_args, next, static_cast<int>(min(static_cast<long long>(RPB), rows - next)),
                   n_io);
    } else {
      const size_t bytes = static_cast<size_t>(min(static_cast<long long>(RPB), rows - next)) * n_io * sizeof(T);
      const char* nr = reinterpret_cast<const char*>(xr + next * n_io);
      [[maybe_unused]] const char* ni =
          kTwo ? reinterpret_cast<const char*>(xi + next * n_io) : nullptr;
      for (size_t b = threadIdx.x * 128; b < bytes; b += kThreads * 128) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(nr + b));
        if constexpr (kTwo) asm volatile("prefetch.global.L2 [%0];" ::"l"(ni + b));
      }
    }
  }

  const Mat f16 = load_matrix(mats);
  Frag x[kTiles];
  if constexpr (IO::kSummed) {
    // the sums over users in f32, one user's points at a time (its loads
    // all issue before the first sum waits on them), each half rounded to
    // bf16 as the A operand
    typename IO::Row w[kTiles];
    float2 acc[kTiles][4][2];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      w[i] = IO::at(io_args, live[i] ? row[i] : 0, n_io);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r][0] = acc[i][r][1] = make_float2(0.0f, 0.0f);
    }
    for (int u = 0; u < io_args.n_usr; ++u) {
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        const float2* __restrict__ s = IO::symbols(io_args, w[i], u, n_io);
        const float2* __restrict__ pv = IO::precoder(io_args, w[i], u);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = 16 * tau[i] + g + 8 * (r & 1) + TPR * (2 * q + 8 * (r >> 1) + e);
            const int src = live[i] ? io_index<SC, N>(p, h) : -1;
            acc[i][r][e] = IO::add_term(acc[i][r][e], IO::point(s, src), IO::point(pv, src));
          }
      }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        x[i].re[r] = pack(acc[i][r][0].x, acc[i][r][1].x);
        x[i].im[r] = pack(acc[i][r][0].y, acc[i][r][1].y);
      }
  } else {
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const size_t off = live[i] ? static_cast<size_t>(row[i]) * n_io : 0;
      const T* __restrict__ rr = xr + off;
      const T* __restrict__ ri = kTwo ? xi + off : nullptr;
      const auto at = IO::at(io_args, live[i] ? row[i] : 0, n_io);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (IO::kPairs) {
          int src[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = 16 * tau[i] + g + 8 * (r & 1) + TPR * (2 * q + 8 * (r >> 1) + e);
            src[e] = live[i] ? io_index<SC, N>(p, h) : -1;
          }
          IO::load_pair(rr, ri, at, src[0], src[1], x[i].re[r], x[i].im[r]);
        } else {
          float2 v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = 16 * tau[i] + g + 8 * (r & 1) + TPR * (2 * q + 8 * (r >> 1) + e);
            const int src = io_index<SC, N>(p, h);
            v[e] = live[i] && src >= 0 ? IO::load(rr, ri, at, src) : make_float2(0.0f, 0.0f);
          }
          x[i].re[r] = pack(v[0].x, v[1].x);
          x[i].im[r] = pack(v[0].y, v[1].y);
        }
      }
    }
  }

  // IFFT pass 1, twiddle conj(W^(t k)) / sqrt(N), exchange 1
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    Acc y;
    tile_dft<true>(x[i], f16, y);
    twiddle<true>(y, tw1 + 256 * tau[i]);
    to_smem<false, N>(buf0[i], 2 * (16 * tau[i] + rm) + rh, round_frag(y));
  }
  exchange_sync<R>();
#pragma unroll
  for (int i = 0; i < kTiles; ++i) from_smem<true, N>(buf0[i], 2 * (tau[i] + R * ck) + cm, x[i]);

  // IFFT pass 2; with a third pass, twiddle conj(W^(16 a c)) and exchange 2
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    Acc y;
    tile_dft<true>(x[i], f16, y);
    if constexpr (R > 1) {
      const int a = tau[i];
      twiddle<true, true>(y, tw2 + 128 * a);
      to_smem<false, N>(buf1[i], 2 * (rm * R + a) + rh, round_frag(y));
    } else {   // the time samples: PA
      pa(y, pa_model, live[i] ? sat[row[i]] : 1.0f, live[i] ? coeff[row[i]] : 0.0f, rapp_p,
         rapp_exp);
      x[i] = round_frag(y);
    }
  }

  if constexpr (R > 1) {
    const Mat fr = R == 16 ? f16 : load_matrix(mats + 128);
    exchange_sync<R>();
    // IFFT pass 3, PA, FFT pass 3 (its transpose), twiddle W^(16 a c),
    // exchange 2 back
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int u = 2 * (16 * tau[i] + ck) + cm;
      from_smem<true, N>(buf1[i], u, x[i]);
      Acc y;
      tile_dft<true>(x[i], fr, y);
      pa(y, pa_model, live[i] ? sat[row[i]] : 1.0f, live[i] ? coeff[row[i]] : 0.0f, rapp_p,
         rapp_exp);
      tile_dft<false>(round_frag(y), fr, y);
      twiddle<false>(y, tw3);
      to_smem<true, N>(buf0[i], u, round_frag(y));
    }
    exchange_sync<R>();
#pragma unroll
    for (int i = 0; i < kTiles; ++i) from_smem<false, N>(buf0[i], 2 * (rm * R + tau[i]) + rh, x[i]);
  }

  // FFT pass 2, twiddle W^(t k) / sqrt(N), exchange 1 back
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    Acc y;
    tile_dft<false>(x[i], f16, y);
    twiddle<false>(y, tw4 + 256 * tau[i]);
    to_smem<true, N>(buf1[i], 2 * (tau[i] + R * ck) + cm, round_frag(y));
  }
  exchange_sync<R>();

  // FFT pass 1 and the store
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    from_smem<false, N>(buf1[i], 2 * (16 * tau[i] + rm) + rh, x[i]);
    Acc y;
    tile_dft<false>(x[i], f16, y);
    if (!live[i]) continue;
    const size_t off = static_cast<size_t>(row[i]) * n_io;
    T* __restrict__ wr = outr + off;
    T* __restrict__ wi = kTwo ? outi + off : nullptr;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * tau[i] + g + 8 * (e >> 1) + TPR * (8 * hh + 2 * q + (e & 1));
        const int dst = io_index<SC, N>(p, h);
        if (dst >= 0) IO::store(wr, wi, dst, make_float2(y.re[hh][e], y.im[hh][e]));
      }
  }
}

// The bf16 layouts run the tensor-core kernel, the f32 ones the CUDA-core one.
template <typename IO> struct TensorCores : std::false_type {};
template <> struct TensorCores<Planes<__nv_bfloat16>> : std::true_type {};
template <> struct TensorCores<Interleaved<true>> : std::true_type {};
template <> struct TensorCores<Precoded<__nv_bfloat16>> : std::true_type {};
template <> struct TensorCores<PrecodedMu<true>> : std::true_type {};

template <int LOG2N, bool SC, typename IO>
struct Instance {
  static constexpr bool kTensor = TensorCores<IO>::value;
  static constexpr int kSmem = kTensor ? tc::kSmemBytes : kSmemBytes;
  // rows a block: 16 points a thread, or 256 a tile
  static constexpr int kRows = (kTensor ? tc::kBlockTiles * 256 : kThreads * kPoints) >> LOG2N;
  static auto kernel() {
    if constexpr (kTensor) return fused_ifft_pa_fft_tc_kernel<LOG2N, SC, IO>;
    else return fused_ifft_pa_fft_kernel<LOG2N, SC, IO>;
  }
};

// Sets one instantiation up on the current device, once per device (the
// calls cost microseconds of host time): lets it take its dynamic shared
// memory, and writes how many of its blocks the card holds at once.
template <int LOG2N, bool SC, typename IO>
int setup(int* resident) {
  using I = Instance<LOG2N, SC, IO>;
  static std::atomic<int> cache[64];   // per device; 0 until set up
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = cache[dev & 63].load(std::memory_order_relaxed);
  if (*resident) return 0;
  auto kern = I::kernel();
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, I::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, I::kSmem);
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
  const float2* sym;   // the precoded layouts' symbols (precoded_mu: every user's), else null
  const float2* det;   // precoded_mu: the replica pass's detections, else null
  long long v_strides[3];   // precoded_mu: V's frame, antenna and user strides
  int n_ant, n_usr, rows, n_io, pa_model;
  float rapp_p, rapp_exp, norm;
  cudaStream_t stream;

  template <int LOG2N, bool SC, typename IO>
  int run() const {
    using T = typename IO::Elem;
    int resident = 0;
    if (const int err = setup<LOG2N, SC, IO>(&resident)) return err;
    using I = Instance<LOG2N, SC, IO>;
    const int blocks = (rows + I::kRows - 1) / I::kRows;
    const auto kern = I::kernel();
    kern<<<blocks, kThreads, I::kSmem, stream>>>(
        static_cast<const T*>(xr), static_cast<const T*>(xi),
        static_cast<T*>(outr), static_cast<T*>(outi), sat, coeff, tw, rows, n_io,
        pa_model, rapp_p, rapp_exp, norm, resident, IO::args(*this));
    return static_cast<int>(cudaGetLastError());
  }
};

// registers, local bytes (spills and stack), static and dynamic shared
// memory, resident blocks per SM, 1 for the tensor-core kernel
struct AttributesArgs {
  int* out;

  template <int LOG2N, bool SC, typename IO>
  int run() const {
    using I = Instance<LOG2N, SC, IO>;
    auto kern = I::kernel();
    int resident = 0;
    if (const int e = setup<LOG2N, SC, IO>(&resident)) return e;
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, I::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.localSizeBytes);
    out[2] = static_cast<int>(fa.sharedSizeBytes);
    out[3] = I::kSmem;
    out[4] = blocks;
    out[5] = I::kTensor;
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

enum Io { kPlanes = 0, kInterleaved = 1, kPrecoded = 2, kPrecodedMu = 3 };

// 5 sizes x 2 modes x 4 layouts, and 5 sizes of the 4 precoded layouts in sc
// mode: 60 instantiations, the 30 of the bf16 layouts on the tensor cores
template <typename Op>
int dispatch(const Op& op, int log2n, int sc_mode, int bf16, int io) {
  switch (io) {
    case kPlanes:
      return bf16 ? by_mode<Planes<__nv_bfloat16>>(op, log2n, sc_mode)
                  : by_mode<Planes<float>>(op, log2n, sc_mode);
    case kInterleaved:
      return bf16 ? by_mode<Interleaved<true>>(op, log2n, sc_mode)
                  : by_mode<Interleaved<false>>(op, log2n, sc_mode);
    case kPrecoded:   // the subcarrier chain's prologue: sc mode only
      if (!sc_mode) return static_cast<int>(cudaErrorInvalidValue);
      return bf16 ? by_size<true, Precoded<__nv_bfloat16>>(op, log2n)
                  : by_size<true, Precoded<float>>(op, log2n);
    case kPrecodedMu:   // the multi-user chain's prologue: sc mode only
      if (!sc_mode) return static_cast<int>(cudaErrorInvalidValue);
      return bf16 ? by_size<true, PrecodedMu<true>>(op, log2n)
                  : by_size<true, PrecodedMu<false>>(op, log2n);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of contiguous
// tensors. `io` names the layout (enum Io): real and imag planes (float or
// bf16 by `bf16`); one complex64 array a side in xr/outr (xi, outi null),
// its halves rounded to bf16 on load and store when `bf16` is set; or, sc
// mode only, the planes of the precoder V in xr/xi and the frames'
// complex64 symbols in `sym`, n_ant rows a frame, and output planes; or, sc
// mode only, the complex64 precoder V [frames, n_ant, n_usr, n_io] in xr
// (strides `v_frame`, `v_ant`, `v_user`; its points contiguous), every
// user's complex64 symbols [frames, n_usr, n_io] in `sym`, with `det` the
// replica pass's detections [n_usr, frames, n_io] (rows [n_usr, frames,
// n_ant]) or null (rows [frames, n_ant]), and complex64 output in outr. `tw` is
// kernels/fused_pa.py::twiddle_table(n_fft) on the device for the f32
// layouts, tensor_kernel_table(n_fft) for the bf16 ones; `stream` is the
// cudaStream_t of the caller's current stream. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fused_ifft_pa_fft_launch(const void* xr, const void* xi,
                                        void* outr, void* outi,
                                        const float* sat, const float* coeff,
                                        const void* tw, const void* sym, const void* det,
                                        int n_ant, int n_usr, long long v_frame,
                                        long long v_ant, long long v_user,
                                        int rows, int log2n, int n_io, int sc_mode,
                                        int bf16, int io, int pa_model,
                                        float rapp_p, float rapp_exp,
                                        float norm, void* stream) {
  if (rows <= 0) return 0;
  if ((io == kPrecoded || io == kPrecodedMu) && (sym == nullptr || n_ant <= 0 || rows % n_ant))
    return static_cast<int>(cudaErrorInvalidValue);
  if (io == kPrecodedMu && (n_usr <= 0 || (det != nullptr && rows % (n_usr * n_ant))))
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchArgs args{xr, xi, outr, outi, sat, coeff,
                        static_cast<const float2*>(tw), static_cast<const float2*>(sym),
                        static_cast<const float2*>(det), {v_frame, v_ant, v_user},
                        n_ant, n_usr, rows, n_io, pa_model, rapp_p, rapp_exp, norm,
                        static_cast<cudaStream_t>(stream)};
  return dispatch(args, log2n, sc_mode, bf16, io);
}

// Resources of one instantiation, written to out[0..5]: registers a thread,
// local memory bytes a thread, static and dynamic shared memory bytes a
// block, resident blocks per SM, and 1 if it runs on the tensor cores.
// Returns a CUDA error code (0 on success).
extern "C" int fused_ifft_pa_fft_attributes(int log2n, int sc_mode, int bf16, int io,
                                            int* out) {
  return dispatch(AttributesArgs{out}, log2n, sc_mode, bf16, io);
}
