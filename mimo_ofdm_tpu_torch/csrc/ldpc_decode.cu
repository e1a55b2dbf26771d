// Flooding belief-propagation decode of a quasi-cyclic LDPC code, the
// decoder of ops/ldpc.py::decode on CUDA tensors (reference/main_cnc_mcnc_w_ldpc/
// mp_ldpc_model.py:174-175, MATLAB nrLDPCDecode's flooding sum-product).
// It replaces no TPU kernel: the JAX package leaves its decoder to XLA.
// Eagerly it is about 28 launches an iteration over the padded check rows
// [W, n_chk, d_c] and variable slots [W, n_var, d_v], several GB of device
// memory traffic an iteration at W = 160 codewords of BG1 at Zc 288.
//
// It runs the same schedule and the same float32 arithmetic as the plain
// version, ops/ldpc.py::_decode, for n_iters iterations in full:
//
//   v2c   = total[var] - c2v                                 (check k of a row)
//   sum-product: phi_k = -log(tanh(clamp(|v2c_k|, 1e-6, 30) / 2))
//                c2v_k = s_k * -log(tanh(clamp(sum phi - phi_k, 1e-6, 30) / 2))
//   min-sum:     c2v_k = s_k * (normalization * (k == argmin ? second min : min))
//   s_k   = the product of the row's signs times sign(v2c_k), a zero sign +1
//   total = llr + sum c2v over the variable's checks
//   hard  = total < 0 for the first K variables, after the last iteration
//
// Only the order of the float32 sums differs from torch's reductions: each
// sum runs in one thread, from +0, in block-column order for a check row and
// block-row order for a variable (the plain version's slot orders). tanhf and
// logf are the CUDA math library's, as PyTorch's own kernels call them, and
// every rounding that a separate PyTorch operation makes is an explicit .rn
// here, so that nothing is contracted into an FMA across it.
//
// Layout. Messages stay in the code's quasi-cyclic block layout: c2v is
// float32 [W, n_blocks, Z], one plane of Z messages for each nonzero block
// (i, j) of the base matrix, row by row (295 planes, 340 KB a codeword, for
// BG1). Check r of block row i meets, in block (i, j) with shift s, variable
// j Z + (r + s) mod Z; so a warp of consecutive checks reads consecutive
// totals and consecutive plane entries, with one wrap, and a warp of
// consecutive variables reads consecutive plane entries (c - s) mod Z. The
// per-code tables (below) are built once on the host.
//
// What bounds it on an H100: the transcendentals, then device memory. The
// sum-product check kernel evaluates two tanhf and two logf an edge, each a
// chain of dependent instructions, about 120 instructions an edge with the
// rest (0.6 ms of instruction throughput a decode of 160 BG1 codewords at
// Zc 288, 12 iterations); an iteration also reads the totals (gathered) and the
// messages and writes the messages, then the variable kernel reads the
// messages and the LLRs and writes the totals: about 240 MB, more than the
// 50 MB L2 holds (0.7 ms a decode at 3.35 TB/s, were it all device memory).
// Measured there (H100 SXM, 700 W): 1.93 ms a decode, the check kernel
// about 115 us an iteration and the variable kernel about 42 us. The floor
// of portbench/roofline_ldpc.py, 14.6 us, counts 6 operations an edge and
// no transcendental. Two launches an iteration:
//   * ldpc_check_kernel: one thread a check (w, i, r). Its row's <= MAXD
//     phi values (or, for min-sum, the two least magnitudes) and sign bits
//     stay in registers between the two passes over the row. The edges go
//     kGroup at a time, so that a group's phi chains interleave: one edge
//     at a time, each chain waits on the one before, and the decode took
//     3.0 ms. At most 64 registers a thread (8 blocks an SM) leave no
//     instantiation spilling. In the first iteration c2v is zero: the
//     thread reads the LLRs and no messages, and nothing is zero-filled.
//   * ldpc_variable_kernel: one thread a variable (w, j, c); after the last
//     iteration only the first K variables, whose hard bits it writes.
// No atomics and fixed sum orders: a codeword's bits do not depend on the
// run or on the other codewords of the batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // a block
constexpr int kGroup = 4;       // a check row's edges taken together (MAXD is a multiple)
constexpr int kCheckBlocks = 8; // resident check-kernel blocks an SM (at most 64 registers)
constexpr int kSumProduct = 0;
constexpr int kMinSum = 1;

// The code's tables on the device. Block b (row-major order over the
// nonzero blocks) owns c2v plane b. row_blocks[b] = (j Z, shift) row by row,
// increasing j; col_blocks = (b Z, shift) column by column, increasing i.
struct Code {
  const int2* row_blocks;   // [n_blocks]
  const int2* col_blocks;   // [n_blocks]
  const int* row_start;     // [m_b + 1] first entry of each block row
  const int* col_start;     // [n_b + 1] first entry of each block column
  int z, m_b, n_b, k_b, n_blocks;
};

__device__ __forceinline__ float clamp_msg(float x) { return fminf(fmaxf(x, 1e-6f), 30.0f); }

// -log(tanh(x / 2)), with x / 2 rounded on its own (torch's separate divide)
__device__ __forceinline__ float phi(float x) { return -logf(tanhf(__fmul_rn(x, 0.5f))); }

template <int ALG, int MAXD, bool FIRST>
__global__ void __launch_bounds__(kThreads, kCheckBlocks)
    ldpc_check_kernel(Code c, const float* __restrict__ total, float* c2v, int words,
                      float normalization) {
  const int checks = c.m_b * c.z;
  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= words * checks) return;
  const int w = item / checks;
  const int i = (item - w * checks) / c.z;
  const int r = item - w * checks - i * c.z;
  const float* t = total + static_cast<size_t>(w) * c.n_b * c.z;
  float* msg = c2v + static_cast<size_t>(w) * c.n_blocks * c.z + r;
  const int e0 = __ldg(c.row_start + i);
  const int d = __ldg(c.row_start + i + 1) - e0;

  // The edges go kGroup at a time: a group's loads and its kGroup phi
  // evaluations (each a chain of dependent tanhf and logf instructions) are
  // independent, so they interleave; edges past the row's degree repeat its
  // last edge's loads and are left out of the sums, the signs and the stores.
  uint32_t neg = 0;             // bit k: v2c_k < 0
  float kept[MAXD];             // sum-product: phi_k
  float sum = 0.0f;             // sum-product: sum of phi
  float min1 = __int_as_float(0x7f800000), min2 = min1;   // min-sum: least two |v2c|
  int arg1 = 0;                 // min-sum: first k of the least
#pragma unroll
  for (int g = 0; g < MAXD; g += kGroup) {
    if (g < d) {
      float mag[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = e0 + (g + u < d ? g + u : d - 1);
        const int2 b = __ldg(c.row_blocks + e);
        int col = r + b.y;
        if (col >= c.z) col -= c.z;
        float v = __ldg(t + b.x + col);
        if constexpr (!FIRST) v = __fsub_rn(v, msg[static_cast<size_t>(e) * c.z]);
        if (g + u < d) neg |= (v < 0.0f ? 1u : 0u) << (g + u);
        mag[u] = fabsf(v);
        if constexpr (ALG == kSumProduct) kept[g + u] = phi(clamp_msg(mag[u]));
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (g + u < d) {
          if constexpr (ALG == kSumProduct) {
            sum = __fadd_rn(sum, kept[g + u]);
          } else if (mag[u] < min1) {
            min2 = min1;
            min1 = mag[u];
            arg1 = g + u;
          } else if (mag[u] < min2) {
            min2 = mag[u];
          }
        }
      }
    }
  }
  const uint32_t parity = __popc(neg) & 1u;
#pragma unroll
  for (int g = 0; g < MAXD; g += kGroup) {
    if (g < d) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = g + u;
        const float m = ALG == kSumProduct
                            ? phi(clamp_msg(__fsub_rn(sum, kept[k])))
                            : __fmul_rn(normalization, k == arg1 ? min2 : min1);
        if (k < d) msg[static_cast<size_t>(e0 + k) * c.z] = (parity ^ ((neg >> k) & 1u)) ? -m : m;
      }
    }
  }
}

// total = llr + (sum of the variable's messages, from +0 in block-row order);
// written to `total` where given, and total < 0 to `hard` for the first K
// variables where given. FIRST: every message is zero (no iteration ran).
template <bool FIRST>
__global__ void __launch_bounds__(kThreads)
    ldpc_variable_kernel(Code c, const float* __restrict__ llr, const float* __restrict__ c2v,
                         float* __restrict__ total, int8_t* __restrict__ hard, int words,
                         int cols) {
  const int per_word = cols * c.z;
  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= words * per_word) return;
  const int w = item / per_word;
  const int j = (item - w * per_word) / c.z;
  const int v = item - w * per_word - j * c.z;
  float acc = 0.0f;
  if constexpr (!FIRST) {
    const float* planes = c2v + static_cast<size_t>(w) * c.n_blocks * c.z;
    const int e1 = __ldg(c.col_start + j + 1);
    for (int e = __ldg(c.col_start + j); e < e1; ++e) {
      const int2 b = __ldg(c.col_blocks + e);
      int r = v - b.y;
      if (r < 0) r += c.z;
      acc = __fadd_rn(acc, __ldg(planes + b.x + r));
    }
  }
  const size_t at = static_cast<size_t>(w) * c.n_b * c.z + j * c.z + v;
  const float tot = __fadd_rn(__ldg(llr + at), acc);
  if (total) total[at] = tot;
  if (hard && j < c.k_b) hard[static_cast<size_t>(w) * c.k_b * c.z + j * c.z + v] = tot < 0.0f;
}

unsigned grid(int items) { return static_cast<unsigned>((items + kThreads - 1) / kThreads); }

template <int ALG, int MAXD>
void check(bool first, const Code& c, const float* total, float* c2v, int words,
           float normalization, cudaStream_t stream) {
  const unsigned blocks = grid(words * c.m_b * c.z);
  if (first)
    ldpc_check_kernel<ALG, MAXD, true>
        <<<blocks, kThreads, 0, stream>>>(c, total, c2v, words, normalization);
  else
    ldpc_check_kernel<ALG, MAXD, false>
        <<<blocks, kThreads, 0, stream>>>(c, total, c2v, words, normalization);
}

template <int ALG>
void check_for(int maxd, bool first, const Code& c, const float* total, float* c2v, int words,
               float normalization, cudaStream_t stream) {
  if (maxd <= 8)
    check<ALG, 8>(first, c, total, c2v, words, normalization, stream);
  else if (maxd <= 16)
    check<ALG, 16>(first, c, total, c2v, words, normalization, stream);
  else if (maxd <= 24)
    check<ALG, 24>(first, c, total, c2v, words, normalization, stream);
  else
    check<ALG, 32>(first, c, total, c2v, words, normalization, stream);
}

void variable(bool first, const Code& c, const float* llr, const float* c2v, float* total,
              int8_t* hard, int words, int cols, cudaStream_t stream) {
  const unsigned blocks = grid(words * cols * c.z);
  if (first)
    ldpc_variable_kernel<true>
        <<<blocks, kThreads, 0, stream>>>(c, llr, c2v, total, hard, words, cols);
  else
    ldpc_variable_kernel<false>
        <<<blocks, kThreads, 0, stream>>>(c, llr, c2v, total, hard, words, cols);
}

// every instantiation, in the order of kernels/ldpc_decode.py::INSTANTIATIONS
const void* const kKernels[] = {
    reinterpret_cast<const void*>(ldpc_check_kernel<kSumProduct, 8, true>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kSumProduct, 8, false>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kSumProduct, 16, true>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kSumProduct, 16, false>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kSumProduct, 24, true>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kSumProduct, 24, false>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kSumProduct, 32, true>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kSumProduct, 32, false>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kMinSum, 8, true>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kMinSum, 8, false>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kMinSum, 16, true>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kMinSum, 16, false>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kMinSum, 24, true>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kMinSum, 24, false>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kMinSum, 32, true>),
    reinterpret_cast<const void*>(ldpc_check_kernel<kMinSum, 32, false>),
    reinterpret_cast<const void*>(ldpc_variable_kernel<true>),
    reinterpret_cast<const void*>(ldpc_variable_kernel<false>),
};

// The n_iters iterations of `words` codewords: 2 n_iters launches (1 when
// n_iters is 0).
cudaError_t decode(const Code& c, int max_row_degree, const float* llr, float* c2v, float* total,
                   int8_t* hard, float* beliefs, int words, int n_iters, int algorithm,
                   float normalization, cudaStream_t stream) {
  if (words == 0) return cudaSuccess;
  const auto check_fn = algorithm == kSumProduct ? check_for<kSumProduct> : check_for<kMinSum>;
  const int out_cols = beliefs ? c.n_b : c.k_b;
  if (n_iters == 0) {
    variable(true, c, llr, nullptr, beliefs, hard, words, out_cols, stream);
    return cudaGetLastError();
  }
  for (int it = 0; it < n_iters; ++it) {
    if (it > 0) {
      variable(false, c, llr, c2v, total, nullptr, words, c.n_b, stream);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    check_fn(max_row_degree, it == 0, c, it == 0 ? llr : total, c2v, words, normalization,
             stream);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  variable(false, c, llr, c2v, beliefs, hard, words, out_cols, stream);
  return cudaGetLastError();
}

}  // namespace

// One decode of `words` codewords on the current stream: llr float32
// [words, n_b z]; tables int32, the code's row_blocks, col_blocks (int2 each,
// n_blocks of them), row_start (m_b + 1) and col_start (n_b + 1), in that
// order; c2v float32 scratch [words, n_blocks, z]; total float32 scratch
// [words, n_b z] (unused when n_iters < 2); hard int8 [words, k_b z]; beliefs
// float32 [words, n_b z] or null: where given, the beliefs after the last
// iteration are written there too. max_row_degree <= 32; algorithm 0 is
// sum-product, 1 normalised min-sum. Returns a CUDA error code (0 on
// success).
extern "C" int ldpc_decode_launch(const int* tables, int z, int m_b, int n_b, int k_b,
                                  int n_blocks, int max_row_degree, const float* llr,
                                  float* c2v, float* total, int8_t* hard, float* beliefs,
                                  int words, int n_iters, int algorithm, float normalization,
                                  void* stream_ptr) {
  if (z <= 0 || m_b <= 0 || n_b <= m_b || k_b != n_b - m_b || n_blocks <= 0 || n_iters < 0 ||
      max_row_degree < 1 || max_row_degree > 32 || words < 0 ||
      (algorithm != kSumProduct && algorithm != kMinSum) ||
      static_cast<long long>(words) * n_b * z > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int2* blocks = reinterpret_cast<const int2*>(tables);
  const Code c{blocks, blocks + n_blocks, tables + 4 * n_blocks,
               tables + 4 * n_blocks + m_b + 1, z, m_b, n_b, k_b, n_blocks};
  return static_cast<int>(decode(c, max_row_degree, llr, c2v, total, hard, beliefs, words,
                                 n_iters, algorithm, normalization,
                                 static_cast<cudaStream_t>(stream_ptr)));
}

// Resources of instantiation `index` (kernels/ldpc_decode.py::INSTANTIATIONS),
// written to out[0..2]: registers a thread, local memory bytes a thread
// (non-zero when ptxas spills), resident blocks per SM. Returns a CUDA error
// code.
extern "C" int ldpc_decode_attributes(int index, int* out) {
  if (index < 0 || index >= static_cast<int>(sizeof(kKernels) / sizeof(kKernels[0])))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kKernels[index]);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kKernels[index], kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = blocks;
  return 0;
}
