// pixelrec_multimodal_tpu_torch/ops/csrc/mlp_chain.cuh
//
// The part the pair-scoring kernels share (pairwise_mlp.cu, K1;
// gated_pairwise_mlp.cu, K2; gated_factored_mlp.cu, K3; and the attention
// kernels through attention_common.cuh): the BatchNorm-folded hidden Dense
// chain on a block's assembled pair rows, its epilogue and the one-column
// last layer, plus the host-side set-up of a launch. Each kernel assembles
// its first-layer activations its own way into buf_a and then calls
// run_chain. The bf16 modes of K1-K3 and the attention kernels K4-K6 run
// it in blocks of 32 and 16 pair rows, and K1-K3 in a 64-row block whose
// wgmma layout does not fit (the chain [1024, 512, 256]: 224,768 B of
// shared memory here); at 128 and 64 rows they run the wgmma chain of
// mlp_chain_wgmma.cuh, which keeps this chain's contract and rounding
// points. The int8 modes K1q-K3q run mlp_chain_int8.cuh.
//
// Counterpart of pixelrec_multimodal_tpu/ops/pairwise_mlp.py:_mlp_chain:
//   for each hidden Dense (W [K, N] bf16, b [N]):
//        x = bf16(act(bf16(x @ W + bf16(b))))   bf16 operands, f32 accumulate
//   s  = sum_k f32(x[k]) * bf16(w_last[k, 0]) + b_last[0]   (f32, b_last
//        unrounded), then the final activation (sigmoid / tanh / none).
//
// Block shape: 16 warps own a tile of TB users x TC = 16 items, ROWS = 16 TB
// pair rows, TB = 8, 4, 2 or 1 (a template parameter: 128, 64, 32 or 16
// rows). The launch set-up takes the largest that fits the shared memory
// (ops/pairwise_mlp.py:block_rows asks each kernel's <name>_block_bytes,
// the count below, and the C entry points check it again); the flagship
// widths fit 128. The hidden chain runs on the tensor cores (mma.sync
// m16n8k16, bf16 -> f32, fed by ldmatrix), 128 output columns per pass; the warps lie over the pass as RG = TB row groups
// of 16 rows x 16 / RG column groups (at 128 rows each warp owns 16 rows x
// 64 columns, at 16 rows 16 rows x 8 columns). Each output's sum over K runs
// the same mma steps in the same order whatever the row count, so a smaller
// block gives the same scores bit for bit. The weights stream by cp.async
// through a three-slice shared-memory ring, so two K-slices load while one
// multiplies. The epilogue (bias, bf16 rounding, activation) works on the
// accumulator registers and writes the next layer's bf16 input; two
// activation buffers ping-pong between layers. The one-column last layer is
// a warp-shuffle dot product instead of a 128-wide product that would
// discard 127 columns. Before the chain starts, the ring is the assembly's
// scratch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pairwise {

constexpr int MAX_HIDDEN = 8;  // hidden Dense layers after the assembly
constexpr int TC = 16;         // items per tile
constexpr int NB = 128;        // output columns per pass
constexpr int KS = 32;         // weight rows per shared-memory slice
constexpr int STAGES = 3;      // slices in the ring
constexpr int PAD = 8;         // bf16 row padding (16 bytes): no bank conflicts
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int WSTRIDE = NB + PAD;
constexpr int MAX_TB = 8;                 // users per tile, at most
constexpr int MAX_ROWS = MAX_TB * TC;     // pair rows per block, at most
constexpr int GATE_PAD = 8;    // gate columns of the gated kernels

// The block of TB users x TC items: ROWS pair rows, RG row groups of 16
// rows x CG column groups of WN columns of a pass (NT n8 tiles per warp).
template <int TB>
struct Tile {
  static_assert(TB == 1 || TB == 2 || TB == 4 || TB == 8,
                "a tile holds 1, 2, 4 or 8 users");
  static constexpr int ROWS = TB * TC;
  static constexpr int RG = ROWS / 16;
  static constexpr int CG = WARPS / RG;
  static constexpr int WN = NB / CG;
  static constexpr int NT = WN / 8;
};

struct Chain {
  int n_hidden;
  int width[MAX_HIDDEN + 1];  // width[0] = h1; width[l + 1] = layer l's output
  long long w_off[MAX_HIDDEN];  // element offset of layer l's [K, N] weights
  int b_off[MAX_HIDDEN];      // element offset of layer l's bias
  int stride_a, stride_b;     // row strides (elements) of the two buffers
};

// Activation codes follow ACTIVATIONS in ops/pairwise_mlp.py.
__device__ __forceinline__ float act_fn(float x, int code) {
  switch (code) {
    case 1: {  // gelu, tanh approximation (Flax nn.gelu), in the order
               // of PyTorch's own: x^3 first, then 0.044715 * x^3 + x
      const float x3 = x * x * x;
      return x * (0.5f * (1.f + tanhf(0.7978845608028654f *
                                      (x + 0.044715f * x3))));
    }
    case 2:
      return tanhf(x);
    case 3:  // leaky_relu, slope 0.01
      return x >= 0.f ? x : 0.01f * x;
    case 4:  // silu
      return x / (1.f + expf(-x));
    default:  // relu
      return fmaxf(x, 0.f);
  }
}

// act on a pair of bf16 values, each result rounded to bf16. relu is exact
// in bf16 (a max), so it skips the float round trip.
__device__ __forceinline__ __nv_bfloat162 act_pair(__nv_bfloat162 v, int code) {
  if (code == 0) return __hmax2(v, __float2bfloat162_rn(0.f));
  const float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(act_fn(f.x, code), act_fn(f.y, code));
}

__device__ __forceinline__ float final_fn(float s, int code) {
  if (code == 0) return 1.f / (1.f + expf(-s));
  if (code == 1) return tanhf(s);
  return s;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A operand: the 16x16 bf16 tile at p (row stride in elements), as the four
// 8x8 matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15) that mma.m16n8k16
// takes. Lane l addresses row l % 16, column (l / 16) * 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// Two 8x8 matrices, addressed by lanes 0-7 and 8-15 (the others' addresses
// are not read).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// B operands of two adjacent n8 tiles from a row-major [k, n] tile:
// r[0], r[1] for columns 0-7, r[2], r[3] for columns 8-15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// The B operand of one n8 tile (rows k 0-7 by lanes 0-7, 8-15 by 8-15).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}
// c[0..1]: row lane/4, columns 2*(lane%4) + {0, 1}; c[2..3]: row lane/4 + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Weight rows [k0, k0 + KS) x columns [n0, n0 + NB) of a [K, N] matrix into
// a [KS, WSTRIDE] slice; rows past K and columns past N are not loaded (the
// products that would read them are skipped).
__device__ __forceinline__ void load_slice(const __nv_bfloat16* __restrict__ W,
                                           int K, int N, int k0, int n0,
                                           __nv_bfloat16* dst) {
  const int rows = min(KS, K - k0);
  const int vec = min(NB, N - n0) / 8;
  for (int e = threadIdx.x; e < rows * vec; e += THREADS) {
    const int r = e / vec, v = e - r * vec;
    cp_async16(dst + r * WSTRIDE + v * 8,
               W + (size_t)(k0 + r) * N + n0 + v * 8);
  }
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint2 to_bf16x4(float4 v) {
  return make_uint2(as_u32(__floats2bfloat162_rn(v.x, v.y)),
                    as_u32(__floats2bfloat162_rn(v.z, v.w)));
}
// act on four f32 values, each result rounded to bf16 once (the gated
// kernels' first activation: their assembly is f32).
__device__ __forceinline__ uint2 act_to_bf16x4(float4 v, int code) {
  return make_uint2(
      as_u32(__floats2bfloat162_rn(act_fn(v.x, code), act_fn(v.y, code))),
      as_u32(__floats2bfloat162_rn(act_fn(v.z, code), act_fn(v.w, code))));
}

// Shared memory of a block: the two activation buffers, then the weight
// ring, which first holds `scratch` bytes of the assembly's own data.
template <int TB>
__host__ __device__ __forceinline__ __nv_bfloat16* buffer_b(
    __nv_bfloat16* buf_a, const Chain& ch) {
  return buf_a + Tile<TB>::ROWS * ch.stride_a;
}
template <int TB>
__host__ __device__ __forceinline__ __nv_bfloat16* ring(__nv_bfloat16* buf_a,
                                                        const Chain& ch) {
  return buf_a + Tile<TB>::ROWS * (ch.stride_a + ch.stride_b);
}

// One 128-column pass of a hidden Dense on the tensor cores: acc (zero on
// entry) += in[rows, :K] @ W[:K, n0 : n0 + NB] for the warp's 16 rows and
// NT n8 tiles, the weights through the ring at wbuf. Every thread calls it
// (it synchronises the block); on return every warp is done with the ring
// except for its last slice, and the caller's epilogue ends with a
// __syncthreads before the ring is loaded again.
template <int TB>
__device__ __forceinline__ void chain_pass(
    const __nv_bfloat16* in, int in_stride, const __nv_bfloat16* __restrict__ W,
    int K, int N, int n0, __nv_bfloat16* wbuf,
    float (&acc)[Tile<TB>::NT][4]) {
  using T = Tile<TB>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % T::RG, wc = warp / T::RG;
  const int nk = (K + KS - 1) / KS;
  // Ring: slices s+1 .. s+STAGES-1 load while slice s multiplies. Every
  // iteration commits one (possibly empty) group, so "all but the newest
  // STAGES-2 groups are done" means slice s has landed.
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk) load_slice(W, K, N, p * KS, n0, wbuf + p * KS * WSTRIDE);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<STAGES - 2>();
    // Slice s is visible to all, and every warp is done with slice s-1,
    // whose buffer the next load overwrites.
    __syncthreads();
    const int nxt = s + STAGES - 1;
    if (nxt < nk)
      load_slice(W, K, N, nxt * KS, n0, wbuf + (nxt % STAGES) * KS * WSTRIDE);
    cp_async_commit();
    const __nv_bfloat16* ws = wbuf + (s % STAGES) * KS * WSTRIDE;
    for (int kk = 0; kk < KS && s * KS + kk < K; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, in + (wr * 16 + (lane & 15)) * in_stride + s * KS + kk
                         + (lane >> 4) * 8);
      if constexpr (T::NT >= 2) {
#pragma unroll
        for (int jp = 0; jp < T::NT / 2; ++jp) {
          const int col = wc * T::WN + jp * 16;
          if (n0 + col < N) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, ws + (kk + (lane & 15)) * WSTRIDE + col
                                    + (lane >> 4) * 8);
            mma_bf16(acc[2 * jp], a, b[0], b[1]);
            mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
          }
        }
      } else {
        const int col = wc * T::WN;
        if (n0 + col < N) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, ws + (kk + (lane & 15)) * WSTRIDE + col);
          mma_bf16(acc[0], a, b[0], b[1]);
        }
      }
    }
  }
}

// The hidden chain and the last layer on the block's ROWS pair rows: buf_a
// holds the assembled first-layer activations (bf16, row stride
// ch.stride_a), and every thread has passed a __syncthreads since writing
// them. Row r is user u0 + r / TC, item c0 + r % TC; only rows inside
// [B, C] are written to out.
template <int TB>
__device__ __forceinline__ void run_chain(
    __nv_bfloat16* buf_a, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ w_last,
    const float* __restrict__ b_last, float* __restrict__ out, int B, int C,
    int u0, int c0, const Chain& ch, int act, int fin) {
  using T = Tile<TB>;
  __nv_bfloat16* buf_b = buffer_b<TB>(buf_a, ch);
  __nv_bfloat16* wbuf = ring<TB>(buf_a, ch);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // ---- hidden chain on the tensor cores. Warp (wr, wc) owns rows
  // [wr * 16, +16) and columns [wc * WN, +WN) of each pass.
  const int wr = warp % T::RG, wc = warp / T::RG;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* in = buf_a;
  int in_stride = ch.stride_a;
  __nv_bfloat16* dst_buf = buf_b;
  int dst_stride = ch.stride_b;

  for (int l = 0; l < ch.n_hidden; ++l) {
    const int K = ch.width[l], N = ch.width[l + 1];
    const __nv_bfloat16* W = w + ch.w_off[l];
    const float* bl = bias + ch.b_off[l];
    for (int n0 = 0; n0 < N; n0 += NB) {
      float acc[T::NT][4];
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
      chain_pass<TB>(in, in_stride, W, K, N, n0, wbuf, acc);

      // Epilogue on the accumulators: + bf16 bias (f32 add), round to
      // bf16, act, bf16, into the next layer's input buffer.
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int col = n0 + wc * T::WN + j * 8 + 2 * t;
        if (n0 + wc * T::WN + j * 8 < N) {
          const float b0 = bl[col], b1 = bl[col + 1];
          const int row = wr * 16 + g;
          const __nv_bfloat162 top =
              __floats2bfloat162_rn(acc[j][0] + b0, acc[j][1] + b1);
          const __nv_bfloat162 bot =
              __floats2bfloat162_rn(acc[j][2] + b0, acc[j][3] + b1);
          *reinterpret_cast<__nv_bfloat162*>(dst_buf + row * dst_stride + col) =
              act_pair(top, act);
          *reinterpret_cast<__nv_bfloat162*>(dst_buf + (row + 8) * dst_stride + col) =
              act_pair(bot, act);
        }
      }
      // The layer output is complete before it is read, and every warp is
      // done with the ring before the next pass loads it.
      __syncthreads();
    }
    const __nv_bfloat16* t_in = in;
    in = dst_buf;
    dst_buf = const_cast<__nv_bfloat16*>(t_in);
    const int ts = in_stride;
    in_stride = dst_stride;
    dst_stride = ts;
  }

  // ---- last layer: one live column, f32 dot per pair row.
  const int hl = ch.width[ch.n_hidden];
  const float bias_last = b_last[0];
  for (int r = warp; r < T::ROWS; r += WARPS) {
    float s = 0.f;
    for (int k = lane; k < hl; k += 32)
      s += __bfloat162float(in[r * in_stride + k]) * w_last[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const int u = u0 + r / TC, c = c0 + r % TC;
      if (u < B && c < C) out[(size_t)u * C + c] = final_fn(s + bias_last, fin);
    }
  }
}

// ---- host side

// The chain's layout from the HOST array of n_hidden + 1 widths (each a
// positive multiple of 16): weight and bias offsets, buffer strides.
inline cudaError_t make_chain(int n_hidden, const int* wd, Chain* ch) {
  if (n_hidden < 0 || n_hidden > MAX_HIDDEN) return cudaErrorInvalidValue;
  *ch = Chain{};
  ch->n_hidden = n_hidden;
  int max_a = 0, max_b = 0;
  long long w_off = 0;
  int b_off = 0;
  for (int l = 0; l <= n_hidden; ++l) {
    if (wd[l] <= 0 || wd[l] % 16) return cudaErrorInvalidValue;
    ch->width[l] = wd[l];
    if (l % 2 == 0) max_a = wd[l] > max_a ? wd[l] : max_a;
    else max_b = wd[l] > max_b ? wd[l] : max_b;
    if (l < n_hidden) {
      ch->w_off[l] = w_off;
      ch->b_off[l] = b_off;
      w_off += (long long)wd[l] * wd[l + 1];
      b_off += wd[l + 1];
    }
  }
  ch->stride_a = max_a + PAD;
  ch->stride_b = max_b ? max_b + PAD : 0;
  return cudaSuccess;
}

// Two activation buffers of `rows` pair rows plus the weight ring, which
// first holds `scratch` bytes of the assembly's data.
inline size_t smem_bytes(const Chain& ch, size_t scratch, int rows) {
  const size_t ring = (size_t)STAGES * KS * WSTRIDE * 2;
  return (size_t)rows * (ch.stride_a + ch.stride_b) * 2 +
         (ring > scratch ? ring : scratch);
}

// A block row count the kernels are built for: 128, 64, 32 or 16.
inline bool valid_rows(int rows) {
  return rows == 128 || rows == 64 || rows == 32 || rows == 16;
}

// f(std::integral_constant<int, TB>()) for the tile of `rows` pair rows
// (TB = rows / TC users): each launch instantiates its kernel for the four
// row counts and picks one at run time.
template <typename F>
inline cudaError_t dispatch_rows(int rows, F&& f) {
  switch (rows) {
    case 128: return f(std::integral_constant<int, 8>());
    case 64: return f(std::integral_constant<int, 4>());
    case 32: return f(std::integral_constant<int, 2>());
    case 16: return f(std::integral_constant<int, 1>());
    default: return cudaErrorInvalidValue;
  }
}

// Shared-memory opt-in and grid of a [B users] x [C items] launch of
// `kernel`, a block of `rows` pair rows (rows / TC users) that takes
// `smem` bytes (the caller's smem_bytes or smem_bytes_int8). A block that
// does not fit in shared memory returns cudaErrorInvalidValue.
template <typename Kernel>
inline cudaError_t prepare_launch(Kernel kernel, size_t smem, int B, int C,
                                  int rows, dim3* grid) {
  if (B <= 0 || C <= 0 || !valid_rows(rows)) return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int tb = rows / TC;
  const long long gy = (B + tb - 1) / tb;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3((C + TC - 1) / TC, (unsigned)gy);
  return cudaSuccess;
}

}  // namespace pairwise

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
