// Fused OFDM transmit chain for one antenna row per thread block:
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
// What bounds it on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores). Per canonical row (n_fft 4096, n_sc 2048, sc mode, bf16 planes) the
// kernel moves 16 KB (8 KB in, 8 KB out): 4.9 ns at 3.35 TB/s. The two
// transforms need about 2 x 5 N log2 N = 0.49 MFLOP: 7.3 ns at 67 TFLOP/s. So
// the row is compute-bound on the f32 cores, and every byte in between stays
// on chip.
//
// What the design does about it:
//   * One block keeps its whole row in shared memory as f32 real/imag planes
//     (2 x (4096 + 128) floats = 33.8 KB at n_fft 4096, under the 48 KB static
//     limit). Nothing is written to device memory between the transforms; bf16
//     is converted at load and store only.
//   * Radix-4 stages (one radix-2 stage when log2 n_fft is odd) halve the
//     number of passes over shared memory against radix 2. Index padding
//     (one float every 32) removes the bank conflicts of the short strides.
//   * No permutation anywhere: the IFFT is decimation in frequency (natural
//     order in, digit-reversed order out), the PA is memoryless so it does not
//     care about the order, and the FFT is decimation in time with the stages
//     in reverse order (digit-reversed in, natural out). This is the
//     digit-swap trick of the Pallas kernel, carried to a radix-4 transform.
//   * Twiddles are a host-built table exp(-2 pi i t / n_fft), computed in
//     float64 and rounded to f32, read through the read-only cache; no
//     hardware sine approximations.
//
// Later work (not here): tensor-core DFT stages and fusing the precode and
// antenna combine around the chain.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

enum PaModel { kSoftlim = 0, kRapp = 1, kToi = 2, kNone = 3 };

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Twiddle exp(-+2 pi i e / n): the table holds the forward sign, the inverse
// transform takes the conjugate.
template <bool INV>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw, int e) {
  float2 w = __ldg(tw + e);
  if (INV) w.y = -w.y;
  return w;
}

// In-place 4-point DFT with w4 = -i (forward) or +i (inverse).
template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = make_float2(a0.x + a2.x, a0.y + a2.y);
  const float2 t1 = make_float2(a0.x - a2.x, a0.y - a2.y);
  const float2 t2 = make_float2(a1.x + a3.x, a1.y + a3.y);
  const float2 t3 = make_float2(a1.x - a3.x, a1.y - a3.y);
  // -i * t3 = (t3.y, -t3.x); +i * t3 = (-t3.y, t3.x)
  const float2 mt3 = INV ? make_float2(-t3.y, t3.x) : make_float2(t3.y, -t3.x);
  a0 = make_float2(t0.x + t2.x, t0.y + t2.y);
  a2 = make_float2(t0.x - t2.x, t0.y - t2.y);
  a1 = make_float2(t1.x + mt3.x, t1.y + mt3.y);
  a3 = make_float2(t1.x - mt3.x, t1.y - mt3.y);
}

__device__ __forceinline__ float2 lds(const float* re, const float* im, int i) {
  return make_float2(re[pad(i)], im[pad(i)]);
}

__device__ __forceinline__ void sts(float* re, float* im, int i, float2 v) {
  re[pad(i)] = v.x;
  im[pad(i)] = v.y;
}

// One radix-4 stage over sub-transforms of length L (stride s = L/4):
// DIF = butterfly then twiddle (IFFT direction here), DIT = twiddle then
// butterfly (FFT direction). Each thread owns disjoint groups of 4 points.
template <bool DIF>
__device__ __forceinline__ void radix4_stage(float* re, float* im,
                                             const float2* __restrict__ tw,
                                             int n, int L) {
  const int s = L >> 2;
  const int stride = n / L;
  for (int t = threadIdx.x; t < (n >> 2); t += blockDim.x) {
    const int j = t & (s - 1);
    const int base = ((t - j) << 2) + j;
    float2 a0 = lds(re, im, base);
    float2 a1 = lds(re, im, base + s);
    float2 a2 = lds(re, im, base + 2 * s);
    float2 a3 = lds(re, im, base + 3 * s);
    const int e = j * stride;
    if (DIF) {
      dft4<true>(a0, a1, a2, a3);
      if (j) {
        a1 = cmul(a1, twiddle<true>(tw, e));
        a2 = cmul(a2, twiddle<true>(tw, 2 * e));
        a3 = cmul(a3, twiddle<true>(tw, 3 * e));
      }
    } else {
      if (j) {
        a1 = cmul(a1, twiddle<false>(tw, e));
        a2 = cmul(a2, twiddle<false>(tw, 2 * e));
        a3 = cmul(a3, twiddle<false>(tw, 3 * e));
      }
      dft4<false>(a0, a1, a2, a3);
    }
    sts(re, im, base, a0);
    sts(re, im, base + s, a1);
    sts(re, im, base + 2 * s, a2);
    sts(re, im, base + 3 * s, a3);
  }
  __syncthreads();
}

// The radix-2 stage of length 2 (no twiddles), used when log2 n is odd.
__device__ __forceinline__ void radix2_stage(float* re, float* im, int n) {
  for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
    const int base = t << 1;
    const float2 a0 = lds(re, im, base);
    const float2 a1 = lds(re, im, base + 1);
    sts(re, im, base, make_float2(a0.x + a1.x, a0.y + a1.y));
    sts(re, im, base + 1, make_float2(a0.x - a1.x, a0.y - a1.y));
  }
  __syncthreads();
}

__device__ __forceinline__ float pa_gain(float pwr, int model, float sat,
                                         float coeff, float rapp_p,
                                         float rapp_exp) {
  switch (model) {
    case kSoftlim:
      return pwr <= sat ? 1.0f : sqrtf(sat / (pwr > 0.0f ? pwr : 1.0f));
    case kRapp:
      return powf(1.0f + powf(pwr / sat, rapp_p), rapp_exp);
    case kToi:
      return 1.0f - coeff * pwr;
    default:
      return 1.0f;
  }
}

template <typename T, bool SC>
__global__ void __launch_bounds__(kThreads)
fused_ifft_pa_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                         T* __restrict__ outr, T* __restrict__ outi,
                         const float* __restrict__ sat,
                         const float* __restrict__ coeff,
                         const float2* __restrict__ tw, int log2n, int n_io,
                         int pa_model, float rapp_p, float rapp_exp,
                         float norm) {
  extern __shared__ float smem[];
  const int n = 1 << log2n;
  float* re = smem;
  float* im = smem + pad(n);
  const size_t row = blockIdx.x;
  const T* __restrict__ rin = xr + row * n_io;
  const T* __restrict__ iin = xi + row * n_io;
  const int h = n_io >> 1;

  // load, with the ortho 1/sqrt(n) of the IFFT folded in
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    int src = p;
    if (SC) src = (p >= 1 && p <= h) ? h + p - 1 : (p >= n - h ? p - (n - h) : -1);
    float a = 0.0f, b = 0.0f;
    if (src >= 0) {
      a = to_f32(rin[src]) * norm;
      b = to_f32(iin[src]) * norm;
    }
    re[pad(p)] = a;
    im[pad(p)] = b;
  }
  __syncthreads();

  // IFFT, decimation in frequency: natural order in, digit-reversed out
  int L = n;
  for (; L >= 4; L >>= 2) radix4_stage<true>(re, im, tw, n, L);
  const bool odd = L == 2;
  if (odd) radix2_stage(re, im, n);

  // memoryless PA on the (digit-reversed) time samples
  const float s_row = sat[row];
  const float c_row = coeff[row];
  if (pa_model != kNone) {
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const float a = re[pad(p)], b = im[pad(p)];
      const float g = pa_gain(a * a + b * b, pa_model, s_row, c_row, rapp_p, rapp_exp);
      re[pad(p)] = a * g;
      im[pad(p)] = b * g;
    }
    __syncthreads();
  }

  // FFT, decimation in time with the stages reversed: digit-reversed in,
  // natural order out
  if (odd) radix2_stage(re, im, n);
  for (L = odd ? 8 : 4; L <= n; L <<= 2) radix4_stage<false>(re, im, tw, n, L);

  // store, with the ortho 1/sqrt(n) of the FFT folded in
  T* __restrict__ rout = outr + row * n_io;
  T* __restrict__ iout = outi + row * n_io;
  for (int i = threadIdx.x; i < n_io; i += blockDim.x) {
    const int bin = SC ? (i < h ? n - h + i : i - h + 1) : i;
    rout[i] = from_f32<T>(re[pad(bin)] * norm);
    iout[i] = from_f32<T>(im[pad(bin)] * norm);
  }
}

template <typename T, bool SC>
void launch(const void* xr, const void* xi, void* outr, void* outi,
            const float* sat, const float* coeff, const float2* tw, int rows,
            int log2n, int n_io, int pa_model, float rapp_p, float rapp_exp,
            float norm, cudaStream_t stream) {
  const int n = 1 << log2n;
  const size_t smem = 2 * static_cast<size_t>(n + (n >> 5)) * sizeof(float);
  fused_ifft_pa_fft_kernel<T, SC><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<T*>(outr), static_cast<T*>(outi), sat, coeff, tw, log2n,
      n_io, pa_model, rapp_p, rapp_exp, norm);
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of contiguous
// tensors; `stream` is the cudaStream_t of the caller's current stream.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_ifft_pa_fft_launch(const void* xr, const void* xi,
                                        void* outr, void* outi,
                                        const float* sat, const float* coeff,
                                        const void* tw, int rows, int log2n,
                                        int n_io, int sc_mode, int bf16,
                                        int pa_model, float rapp_p,
                                        float rapp_exp, float norm,
                                        void* stream) {
  if (rows > 0) {
    const float2* t = static_cast<const float2*>(tw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) {
      if (sc_mode)
        launch<__nv_bfloat16, true>(xr, xi, outr, outi, sat, coeff, t, rows, log2n, n_io,
                                    pa_model, rapp_p, rapp_exp, norm, s);
      else
        launch<__nv_bfloat16, false>(xr, xi, outr, outi, sat, coeff, t, rows, log2n, n_io,
                                     pa_model, rapp_p, rapp_exp, norm, s);
    } else {
      if (sc_mode)
        launch<float, true>(xr, xi, outr, outi, sat, coeff, t, rows, log2n, n_io,
                            pa_model, rapp_p, rapp_exp, norm, s);
      else
        launch<float, false>(xr, xi, outr, outi, sat, coeff, t, rows, log2n, n_io,
                             pa_model, rapp_p, rapp_exp, norm, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
