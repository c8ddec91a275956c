// pixelrec_multimodal_tpu_torch/ops/csrc/pairwise_mlp.cu
//
// Fused concat-fusion pair scoring for Hopper (sm_90a): one launch scores a
// [B users] x [C items] block through the factorized, BatchNorm-folded
// prediction MLP and writes the [B, C] f32 score matrix.
//
// Replaces: pixelrec_multimodal_tpu/ops/pairwise_mlp.py:_pairwise_kernel
// (bf16 mode, reached through pallas_pairwise_scores).
//
// What it computes, per (user b, item c) pair:
//   x  = act(bf16(bf16(user_first[b]) + bf16(item_first[c])))   (b1 already
//        folded into item_first: no bias add here)
//   for each hidden Dense (W [K, N] bf16, b [N]):
//        x = bf16(act(bf16(x @ W + bf16(b))))   bf16 operands, f32 accumulate
//   s  = sum_k f32(x[k]) * bf16(w_last[k, 0]) + b_last[0]   (f32, b_last
//        unrounded), then final activation (sigmoid / tanh / none).
// These are the Pallas kernel's rounding points; the module's
// pairwise_scores_plain(compute_dtype=bfloat16) repeats them on tensors.
//
// Bound: at the flagship head (h1 512 -> 256 -> 128 -> 1) a pair costs
// 2*512*256 + 2*256*128 + 2*128 + 3*512 = 329,472 FLOPs and moves almost no
// bytes (the inputs are per-user and per-item rows, read once per tile), so
// the kernel is bound by tensor-core operations, not by memory.
//
// Design against that bound: every activation stays on chip. A block of 16
// warps owns a tile of 8 users x 16 items (128 pair rows; at the flagship
// widths the block's ~222 KB of shared memory fill one SM). It assembles the first-layer activations into shared memory as
// bf16 with packed bf16x2 arithmetic, then runs the hidden chain on the
// tensor cores (mma.sync m16n8k16, bf16 -> f32, fed by ldmatrix), 128
// output columns per pass, each warp 16 rows x 64 columns.
// The weights stream by cp.async through a three-slice shared-memory ring,
// so two K-slices load while one multiplies. The epilogue (bias, bf16
// rounding, activation) works on the accumulator registers and writes the
// next layer's bf16 input; two activation buffers ping-pong between layers.
// The one-column last layer is a warp-shuffle dot product instead of a
// 128-wide product that would discard 127 columns.
// wgmma, TMA and persistent blocks are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_HIDDEN = 8;  // hidden Dense layers after the assembly
constexpr int TC = 16;         // items per tile
constexpr int NB = 128;        // output columns per pass
constexpr int KS = 32;         // weight rows per shared-memory slice
constexpr int STAGES = 3;      // slices in the ring
constexpr int PAD = 8;         // bf16 row padding (16 bytes): no bank conflicts
constexpr int RG = 8;          // warps along the rows; 2 along the columns
constexpr int WARPS = 2 * RG;
constexpr int THREADS = WARPS * 32;
constexpr int WSTRIDE = NB + PAD;
constexpr int ROWS = RG * 16;  // pair rows per block
constexpr int TB = ROWS / TC;  // users per tile

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
    case 1:  // gelu, tanh approximation (Flax nn.gelu)
      return x * (0.5f * (1.f + tanhf(0.7978845608028654f *
                                      (x + 0.044715f * x * x * x))));
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
// B operands of two adjacent n8 tiles from a row-major [k, n] tile:
// r[0], r[1] for columns 0-7, r[2], r[3] for columns 8-15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

__global__ void __launch_bounds__(THREADS)
pairwise_mlp_kernel(const float* __restrict__ uf, const float* __restrict__ itf,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ w_last,
                    const float* __restrict__ b_last, float* __restrict__ out,
                    int B, int C, Chain ch, int act, int fin) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf_b = buf_a + ROWS * ch.stride_a;
  // STAGES x [KS, WSTRIDE] weight ring. Before the first product it holds
  // the tile's user rows as bf16 for the assembly.
  __nv_bfloat16* wbuf = buf_b + ROWS * ch.stride_b;

  const int c0 = blockIdx.x * TC, u0 = blockIdx.y * TB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h1 = ch.width[0];
  const int q = h1 / 4;

  // ---- assembly: buf_a[bu * TC + ci] = act(bf16(u) + bf16(i)), as bf16.
  // The TB user rows are rounded to bf16 once, into the ring; each item
  // float4 is read once from global memory and paired with all TB users.
  // Rows past B or C assemble from zeros and are never written out.
  __nv_bfloat16* users = wbuf;  // [TB, h1]
  for (int e = tid; e < TB * q; e += THREADS) {
    const int bu = e / q, k = (e - bu * q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u0 + bu < B)
      v = __ldg(reinterpret_cast<const float4*>(uf + (size_t)(u0 + bu) * h1 + k));
    *reinterpret_cast<uint2*>(users + bu * h1 + k) = to_bf16x4(v);
  }
  __syncthreads();
  for (int e = tid; e < TC * q; e += THREADS) {
    const int ci = e / q, k = (e - ci * q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 + ci < C)
      v = __ldg(reinterpret_cast<const float4*>(itf + (size_t)(c0 + ci) * h1 + k));
    const uint2 it = to_bf16x4(v);
#pragma unroll
    for (int bu = 0; bu < TB; ++bu) {
      const uint2 u = *reinterpret_cast<const uint2*>(users + bu * h1 + k);
      // bf16 adds, rounded to nearest even: the Pallas kernel's bf16 add.
      const __nv_bfloat162 lo = __hadd2(as_bf162(u.x), as_bf162(it.x));
      const __nv_bfloat162 hi = __hadd2(as_bf162(u.y), as_bf162(it.y));
      *reinterpret_cast<uint2*>(buf_a + (bu * TC + ci) * ch.stride_a + k) =
          make_uint2(as_u32(act_pair(lo, act)), as_u32(act_pair(hi, act)));
    }
  }
  __syncthreads();

  // ---- hidden chain on the tensor cores. Warp (wr, wc) owns rows
  // [wr * 16, +16) and columns [wc * 64, +64) of each pass.
  const int wr = warp % RG, wc = warp / RG;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* in = buf_a;
  int in_stride = ch.stride_a;
  __nv_bfloat16* dst_buf = buf_b;
  int dst_stride = ch.stride_b;

  for (int l = 0; l < ch.n_hidden; ++l) {
    const int K = ch.width[l], N = ch.width[l + 1];
    const __nv_bfloat16* W = w + ch.w_off[l];
    const float* bl = bias + ch.b_off[l];
    const int nk = (K + KS - 1) / KS;
    for (int n0 = 0; n0 < N; n0 += NB) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

      // Ring: slices s+1 .. s+STAGES-1 load while slice s multiplies.
      // Every iteration commits one (possibly empty) group, so "all but
      // the newest STAGES-2 groups are done" means slice s has landed.
#pragma unroll
      for (int p = 0; p < STAGES - 1; ++p) {
        if (p < nk) load_slice(W, K, N, p * KS, n0, wbuf + p * KS * WSTRIDE);
        cp_async_commit();
      }
      for (int s = 0; s < nk; ++s) {
        cp_async_wait<STAGES - 2>();
        // Slice s is visible to all, and every warp is done with slice
        // s-1, whose buffer the next load overwrites.
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
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            const int col = wc * 64 + jp * 16;
            if (n0 + col < N) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, ws + (kk + (lane & 15)) * WSTRIDE + col
                                      + (lane >> 4) * 8);
              mma_bf16(acc[2 * jp], a, b[0], b[1]);
              mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
            }
          }
        }
      }

      // Epilogue on the accumulators: + bf16 bias (f32 add), round to
      // bf16, act, bf16, into the next layer's input buffer.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wc * 64 + j * 8 + 2 * t;
        if (n0 + wc * 64 + j * 8 < N) {
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
  for (int r = warp; r < ROWS; r += WARPS) {
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

// Two activation buffers plus the weight ring, which first holds the tile's
// bf16 user rows.
size_t smem_bytes(const Chain& ch) {
  const size_t ring = (size_t)STAGES * KS * WSTRIDE * 2;
  const size_t users = (size_t)TB * ch.width[0] * 2;
  return (size_t)ROWS * (ch.stride_a + ch.stride_b) * 2 +
         (ring > users ? ring : users);
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) from user_first [B, h1] and item_first
// [C, h1] (f32, row-major, 16-byte aligned rows). w holds the hidden layers'
// [K, N] bf16 weights back to back, bias their biases (f32 holding
// bf16-rounded values), w_last the bf16-rounded live column of the last
// layer [width[n_hidden]] (f32), b_last its bias (element 0 is read).
// widths is a HOST array of n_hidden + 1 ints, each a positive multiple of
// 16. Returns cudaSuccess or the first CUDA error (launch included); a width
// that does not fit in shared memory returns cudaErrorInvalidValue.
int pairwise_mlp_forward(const void* uf, const void* itf, const void* w,
                         const void* bias, const void* w_last,
                         const void* b_last, void* out, int B, int C,
                         int n_hidden, const void* widths, int act, int fin,
                         void* stream) {
  if (n_hidden < 0 || n_hidden > MAX_HIDDEN || B <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  const int* wd = static_cast<const int*>(widths);
  Chain ch = {};
  ch.n_hidden = n_hidden;
  int max_a = 0, max_b = 0;
  long long w_off = 0;
  int b_off = 0;
  for (int l = 0; l <= n_hidden; ++l) {
    if (wd[l] <= 0 || wd[l] % 16) return cudaErrorInvalidValue;
    ch.width[l] = wd[l];
    if (l % 2 == 0) max_a = wd[l] > max_a ? wd[l] : max_a;
    else max_b = wd[l] > max_b ? wd[l] : max_b;
    if (l < n_hidden) {
      ch.w_off[l] = w_off;
      ch.b_off[l] = b_off;
      w_off += (long long)wd[l] * wd[l + 1];
      b_off += wd[l + 1];
    }
  }
  ch.stride_a = max_a + PAD;
  ch.stride_b = max_b ? max_b + PAD : 0;

  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;

  const size_t smem = smem_bytes(ch);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(pairwise_mlp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const long long gy = (B + TB - 1) / TB;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((C + TC - 1) / TC, (unsigned)gy);
  pairwise_mlp_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uf), static_cast<const float*>(itf),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(w_last), static_cast<const float*>(b_last),
      static_cast<float*>(out), B, C, ch, act, fin);
  return cudaGetLastError();
}

const char* pairwise_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
