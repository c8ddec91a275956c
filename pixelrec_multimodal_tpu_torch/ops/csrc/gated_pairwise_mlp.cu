// pixelrec_multimodal_tpu_torch/ops/csrc/gated_pairwise_mlp.cu
//
// Fused gated-fusion pair scoring for Hopper (sm_90a), exact variant: one
// launch scores a [B users] x [C items] block through the factorized,
// BatchNorm-folded gated head and writes the [B, C] f32 score matrix.
//
// Replaces: pixelrec_multimodal_tpu/ops/pairwise_mlp.py:_gated_pairwise_kernel
// (bf16 mode, reached through pallas_pairwise_scores_gated), and, as
// gated_pairwise_mlp_int8_forward, the same kernel's int8 mode (n_quant > 0:
// K2q).
//
// What it computes, per (user b, item c) pair, with M = n_mod modalities
// (the user, then Mi = M - 1 item-side ones), all in f32:
//   l_m = ug[b, m] + ig[c, m]  (m < M; the GATE_PAD - M padding columns
//         never enter the softmax)
//   g_m = e_m * (1 / sum e),  e_m = exp(l_m - max l)
//   x   = g_0 * uf[b] + sum_{m=1..Mi} g_m * itf[c, (m-1)*h1 : m*h1]
//         (b1 is folded into every part: the gates sum to 1)
//   x   = bf16(act(x))  -- the one bf16 rounding of the assembly
// then the shared chain of mlp_chain.cuh. Unlike K1 (pairwise_mlp.cu) the
// user and item parts are not rounded to bf16 before they are combined.
// The module's pairwise_scores_gated_plain(compute_dtype=bfloat16) repeats
// these rounding points on tensors.
//
// Bound: per pair at the flagship head (h1 512 -> 256 -> 128 -> 1, M = 6)
// the hidden products are 2*512*256 + 2*256*128 = 327,680 tensor-core
// operations; the assembly is about 2*M*h1 + h1 + 6*M = 6,692 f32
// operations (the weighted sum, the activation, the softmax) and the last
// dot 2*128. At the data-sheet rates (989 TFLOP/s bf16 tensor, 67 TFLOP/s
// f32) the tensor-core work takes 3x the f32 work, and the bytes (per-user
// and per-item rows read once) are far below either, so the kernel is
// bound by tensor-core operations.
//
// Design: the block shape and the chain are K1's (8 users x 16 items = 128
// pair rows, 16 warps, ~222 KB of shared memory at the flagship widths).
// The item parts of a 16-item tile are 16 x Mi*h1 f32 (160 KB at the
// flagship) and do not fit beside the two activation buffers, so they
// stream from global memory (L2) through registers: each thread loads the
// Mi float4s of one (item, 4-column) slot once and combines them with all
// 8 users of the tile. The f32 user rows (8 x h1) and the per-pair gates
// (128 x GATE_PAD) live in the weight ring until the chain starts. The
// softmax runs once per pair row. The weighted sum is an unfused multiply
// and add per term (__fmul_rn, __fadd_rn), in the plain version's order,
// so that kernel and plain version round the same f32 values to bf16; a
// fused multiply-add would round differently and move some activations to
// the neighbouring bf16 value.
//
// int8 mode (K2q, the template flag Q): the same assembly, each bf16
// activation then quantized with layer 0's (inv_a, off) into an int8 code,
// and the int8 chain of mlp_chain_int8.cuh. Its int8 products take 0.35 ms
// at the data-sheet rate for 256 x 8,192 flagship pairs, while the f32 work
// (the assembly as above plus each hidden layer's quantize and rescale,
// about 11,500 operations per pair) takes about 0.36 ms: bound by f32
// operations.

#include "mlp_chain_int8.cuh"

namespace {

using namespace pairwise;

template <bool Q, int TB>
__global__ void __launch_bounds__(THREADS)
gated_pairwise_kernel(const float* __restrict__ uf, const float* __restrict__ ug,
                      const float* __restrict__ itf,
                      const float* __restrict__ ig,
                      const Weight<Q>* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ w_last,
                      const float* __restrict__ b_last,
                      float* __restrict__ out, int B, int C, int n_mod,
                      Chain ch, int act, int fin) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);

  constexpr int ROWS = Tile<TB>::ROWS;
  const int c0 = blockIdx.x * TC, u0 = blockIdx.y * TB;
  const int tid = threadIdx.x;
  const int h1 = ch.width[0];
  const int q = h1 / 4;
  const int n_item = n_mod - 1;

  // Scratch in the ring: the tile's f32 user rows, then the gates of its
  // pair rows. Rows past B or C assemble from zeros (uniform gates over
  // zero parts) and are never written out.
  float* users = reinterpret_cast<float*>(scratch_of<Q, TB>(smem, ch));  // [TB, h1]
  float* gates = users + TB * h1;                            // [ROWS, GATE_PAD]
  for (int e = tid; e < TB * q; e += THREADS) {
    const int bu = e / q, k = (e - bu * q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u0 + bu < B)
      v = __ldg(reinterpret_cast<const float4*>(uf + (size_t)(u0 + bu) * h1 + k));
    *reinterpret_cast<float4*>(users + bu * h1 + k) = v;
  }
  for (int r = tid; r < ROWS; r += THREADS) {
    const int u = u0 + r / TC, c = c0 + r % TC;
    float l[GATE_PAD];
    float mx = -3.402823466e+38f;  // -FLT_MAX
#pragma unroll
    for (int m = 0; m < GATE_PAD; ++m) {
      l[m] = 0.f;
      if (m < n_mod) {
        l[m] = (u < B ? ug[(size_t)u * GATE_PAD + m] : 0.f) +
               (c < C ? ig[(size_t)c * GATE_PAD + m] : 0.f);
        mx = fmaxf(mx, l[m]);
      }
    }
    float tot = 0.f;
#pragma unroll
    for (int m = 0; m < GATE_PAD; ++m)
      if (m < n_mod) {
        l[m] = expf(l[m] - mx);
        tot += l[m];
      }
    const float inv = 1.f / tot;
#pragma unroll
    for (int m = 0; m < GATE_PAD; ++m)
      gates[r * GATE_PAD + m] = m < n_mod ? l[m] * inv : 0.f;
  }
  // int8 mode: layer 0's (inv_a, off), bias[0] and bias[1]
  float inv_a = 0.f, off = 0.f;
  if constexpr (Q) {
    inv_a = bias[0];
    off = bias[1];
  }
  __syncthreads();

  // ---- assembly: buf_a[bu * TC + ci] = bf16(act(sum_m g_m * part_m))
  // (int8 mode: its codes).
  for (int e = tid; e < TC * q; e += THREADS) {
    const int ci = e / q, k = (e - ci * q) * 4;
    float4 it[GATE_PAD - 1];
#pragma unroll
    for (int m = 0; m < GATE_PAD - 1; ++m) {
      it[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < n_item && c0 + ci < C)
        it[m] = __ldg(reinterpret_cast<const float4*>(
            itf + ((size_t)(c0 + ci) * n_item + m) * h1 + k));
    }
#pragma unroll
    for (int bu = 0; bu < TB; ++bu) {
      const int r = bu * TC + ci;
      const float* g = gates + r * GATE_PAD;
      const float4 u = *reinterpret_cast<const float4*>(users + bu * h1 + k);
      const float g0 = g[0];
      float4 x = make_float4(__fmul_rn(g0, u.x), __fmul_rn(g0, u.y),
                             __fmul_rn(g0, u.z), __fmul_rn(g0, u.w));
#pragma unroll
      for (int m = 0; m < GATE_PAD - 1; ++m)
        if (m < n_item) {
          const float gm = g[m + 1];
          x.x = __fadd_rn(x.x, __fmul_rn(gm, it[m].x));
          x.y = __fadd_rn(x.y, __fmul_rn(gm, it[m].y));
          x.z = __fadd_rn(x.z, __fmul_rn(gm, it[m].z));
          x.w = __fadd_rn(x.w, __fmul_rn(gm, it[m].w));
        }
      if constexpr (Q) {
        *reinterpret_cast<uint32_t*>(smem + r * ch.stride_a + k) =
            quantize_bf16x4(act_to_bf16x4(x, act), inv_a, off);
      } else {
        *reinterpret_cast<uint2*>(buf_a + r * ch.stride_a + k) =
            act_to_bf16x4(x, act);
      }
    }
  }
  __syncthreads();
  if constexpr (Q) {
    run_chain_int8<TB>(smem, w, bias, w_last, b_last, out, B, C, u0, c0, ch,
                       act, fin);
  } else {
    run_chain<TB>(buf_a, w, bias, w_last, b_last, out, B, C, u0, c0, ch, act,
                  fin);
  }
}

// The assembly's scratch in the ring (see the kernel).
inline size_t scratch_bytes(const Chain& ch, int rows) {
  return ((size_t)(rows / TC) * ch.width[0] + (size_t)rows * GATE_PAD) * 4;
}

template <bool Q>
int forward(const void* uf, const void* ug, const void* itf, const void* ig,
            const void* w, const void* bias, const void* w_last,
            const void* b_last, void* out, int B, int C, int n_hidden,
            const void* widths, int act, int fin, int n_mod, int rows,
            void* stream) {
  if (n_mod < 2 || n_mod > GATE_PAD) return cudaErrorInvalidValue;
  Chain ch;
  cudaError_t err = make_chain_of<Q>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_of<Q>(ch, scratch_bytes(ch, rows), rows);
  return dispatch_rows(rows, [&](auto tb) {
    constexpr int TB = decltype(tb)::value;
    dim3 grid;
    cudaError_t e = prepare_launch(gated_pairwise_kernel<Q, TB>, smem, B, C, rows, &grid);
    if (e != cudaSuccess) return e;
    gated_pairwise_kernel<Q, TB><<<grid, THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(uf), static_cast<const float*>(ug),
        static_cast<const float*>(itf), static_cast<const float*>(ig),
        static_cast<const Weight<Q>*>(w), static_cast<const float*>(bias),
        static_cast<const float*>(w_last), static_cast<const float*>(b_last),
        static_cast<float*>(out), B, C, n_mod, ch, act, fin);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) from user_first [B, h1], user_gates
// [B, GATE_PAD], item_first [C, Mi*h1] (modality-major within a row) and
// item_gates [C, GATE_PAD], all f32, row-major, 16-byte aligned rows; only
// the first n_mod gate columns are read (2 <= n_mod <= GATE_PAD). The chain
// arguments (w, bias, w_last, b_last, n_hidden, widths, act, fin) are
// pairwise_mlp_forward's. Returns cudaSuccess or the first CUDA error
// (launch included); rows is the block's pair rows (128, 64, 32 or 16:
// ops/pairwise_mlp.py:block_rows), and a block that does not fit in shared
// memory returns cudaErrorInvalidValue.
int gated_pairwise_mlp_forward(const void* uf, const void* ug, const void* itf,
                               const void* ig, const void* w, const void* bias,
                               const void* w_last, const void* b_last,
                               void* out, int B, int C, int n_hidden,
                               const void* widths, int act, int fin,
                               int n_mod, int rows, void* stream) {
  return forward<false>(uf, ug, itf, ig, w, bias, w_last, b_last, out, B, C,
                        n_hidden, widths, act, fin, n_mod, rows, stream);
}

// The int8 mode (K2q): the arguments of gated_pairwise_mlp_forward, with the
// chain arguments of pairwise_mlp_int8_forward.
int gated_pairwise_mlp_int8_forward(const void* uf, const void* ug,
                                    const void* itf, const void* ig,
                                    const void* w, const void* bias,
                                    const void* w_last, const void* b_last,
                                    void* out, int B, int C, int n_hidden,
                                    const void* widths, int act, int fin,
                                    int n_mod, int rows, void* stream) {
  return forward<true>(uf, ug, itf, ig, w, bias, w_last, b_last, out, B, C,
                       n_hidden, widths, act, fin, n_mod, rows, stream);
}

// Shared memory a block of `rows` pair rows takes in either mode (int8 != 0),
// as the launch set-up counts it; a negative CUDA error for widths the kernel
// does not take.
int gated_pairwise_mlp_block_bytes(int n_hidden, const void* widths, int int8, int rows) {
  Chain ch;
  const cudaError_t err = int8 ? make_chain_of<true>(n_hidden, widths, rows, &ch)
                               : make_chain_of<false>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return -(int)err;
  const size_t scratch = scratch_bytes(ch, rows);
  return (int)(int8 ? smem_of<true>(ch, scratch, rows)
                    : smem_of<false>(ch, scratch, rows));
}

}  // extern "C"
