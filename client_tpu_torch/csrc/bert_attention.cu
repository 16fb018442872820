// K3: fused bidirectional, key-padded attention of the BERT encoder for
// NVIDIA Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package leaves this attention to
// XLA (client_tpu/models/bert.py, `forward`). The port's plain version,
// `encoder_attention_plain` in client_tpu_torch/models/bert.py, computes
// it as seven passes over a [B, H, L, L] score tensor: a bf16 einsum, a
// cast to fp32, a divide by sqrt(hd), a broadcast add of the -1e9 pad
// bias, a softmax, a cast back to the model dtype and a second einsum.
// In the BERT-large `/infer` cell (16 rows an execution, 97 % of them
// padded to L = 512) that is 67 M scores and about 2.7 GB of device
// traffic a layer, about 64 GB and a third of the card's time a forward.
//
//   ctx[b, q, h] = sum_k softmax_k(q[b, q, h] . k[b, k, h] / sqrt(hd)) v[b, k, h]
//
// over the keys k with mask[b, k] set. q, k, v and ctx are [B, L, H, hd]
// (ctx read as [B, L, H * hd]); scores and their scale are fp32, the
// softmax is online in fp32, the probabilities are rounded to the input
// dtype before P.V as the plain version rounds them, the accumulator is
// fp32 and normalised once. A pad key is left out, which is exact: the
// plain version's exp(s - 1e9 - max) is 0 in fp32. A row whose keys are
// all pad gets the mean of V over all L keys, the plain version's uniform
// softmax. Every query row is computed, pad rows included.
//
// What bounds it on this card: at the cell's shape (B 16, L 512, H 16,
// hd 64) it reads q, k, v and writes ctx once, 4 x 16.8 MB = 67 MB a
// layer, 20 us at 3.35 TB/s; its products, after the key tiles with no
// valid key are skipped (0.39 of the padded L^2 over the cell's traffic),
// take about 7 us at 989 TFLOP/s. It is bound by bytes, and no score
// reaches device memory.
//
// The design:
// - One block of 4 warps per (query tile of 64 rows, head, batch row):
//   2,048 blocks at the cell's shape, so every SM has work. A warp owns
//   16 query rows.
// - The block first reads its row's key mask as bits (a ballot a warp
//   word) into shared memory and lists the 64-key tiles holding a valid
//   key; the loop visits only those. No valid key at all: every tile, in
//   uniform mode (each in-range score 0).
// - K and V tiles stream through a ring of two shared-memory stages with
//   cp.async (16-byte copies, rows past L zero-filled), so the next tile
//   is in flight while one is used. Rows are padded by 16 bytes, so that
//   ldmatrix of 8 rows lands on 8 distinct bank groups.
// - bf16: S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16,
//   bf16 in, fp32 accumulate). Q stays in registers as A fragments; K is
//   read with ldmatrix and V with ldmatrix.trans; the scores' accumulator
//   fragments become P's A fragments in registers, rounded to bf16. The
//   row max is reduced over a quad of lanes; the row sum stays a per-lane
//   partial until the end.
// - fp32: the same loop on the CUDA cores in plain FMA (no TF32): two
//   threads a query row, each half of the head dim, 16 keys (8 at
//   hd 128) a softmax update.
// - Head dims 16, 64 and 128; dtypes fp32 and bf16: six instances.
//
// The kernel allocates nothing and does not synchronise. The C entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 64;      // query rows a block, 16 a warp
constexpr int kKTile = 64;      // keys a pipeline stage
constexpr int kMaxTiles = 256;  // key tiles a row may have: L <= 16384
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;               // [B, L, H, D]
  const void* k;               // [B, L, H, D]
  const void* v;               // [B, L, H, D]
  const unsigned char* mask;   // [B, L], nonzero: a real key
  void* out;                   // [B, L, H, D]
  int batch, length, heads;
  float scale;
};

template <typename T, int D>
struct Layout {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies a row
  static constexpr int kCopies = kKTile * kChunks / kThreads;         // a thread's, a tile
  static constexpr int kTileBytes = kKTile * kRowBytes;
  static constexpr int kQBytes = kQTile * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kBytes = kQBytes + 2 * kStageBytes;
  static_assert(kQTile == kKTile, "Q and K/V tiles share the copy");
  static_assert(kKTile * kChunks % kThreads == 0, "every thread copies alike");
};

// 16-byte asynchronous copy global -> shared (a shared-window address);
// with live == false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool live) {
  const int bytes = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned src) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(src)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], unsigned src) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(src)
               : "memory");
}

// c += a . b for a 16x16 bf16 tile a (row-major), a 16x8 bf16 tile b
// (column-major) and a 16x8 fp32 tile c.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// Copy rows [first, first + 64) of a [L, stride] view to a padded tile at
// `dst`; rows at or past `length` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(unsigned dst, const T* src, int first, int length,
                                          int64_t stride) {
  using Ly = Layout<T, D>;
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int i = 0; i < Ly::kCopies; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / Ly::kChunks;
    const int chunk = c % Ly::kChunks;
    const int row = first + r;
    const bool live = row < length;
    cp_async16(dst + r * Ly::kRowBytes + chunk * 16,
               src + (live ? row : 0) * stride + chunk * kPerChunk, live);
  }
}

// The online-softmax step shared by both paths, for one row: the tile's
// row max `tile_max` (over the scores this row's threads hold) updates
// the running max `m`; returns the factor the old sum and accumulator are
// scaled by and sets `base`, the max the new probabilities are taken
// against (0 while the row has seen no valid key, so exp2(-inf) = 0).
__device__ __forceinline__ float rescale(float& m, float tile_max, float& base) {
  const float m_new = fmaxf(m, tile_max);
  base = m_new == -INFINITY ? 0.f : m_new;
  const float alpha = exp2f((m - base) * kLog2e);
  m = m_new;
  return alpha;
}

// One block: query tile blockIdx.x, head blockIdx.y, batch row blockIdx.z.
template <typename T, int D>
__device__ __forceinline__ void attend(const Params& p) {
  using Ly = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_bits[2 * kMaxTiles];  // the row's key mask, a bit a key
  __shared__ int s_tiles[kMaxTiles];          // the tiles to visit
  __shared__ int s_count;
  const unsigned base_addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned q_addr = base_addr;
  const unsigned stage_addr = base_addr + Ly::kQBytes;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int L = p.length;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kQTile;
  const int n_tiles = (L + kKTile - 1) / kKTile;
  const int64_t stride = static_cast<int64_t>(p.heads) * D;  // between two tokens
  const int64_t head0 = (static_cast<int64_t>(b) * L * p.heads + h) * D;
  const T* q = static_cast<const T*>(p.q) + head0;
  const T* k = static_cast<const T*>(p.k) + head0;
  const T* v = static_cast<const T*>(p.v) + head0;
  T* out = static_cast<T*>(p.out) + head0;

  // Q's tile in flight while the mask is read
  load_tile<T, D>(q_addr, q, q0, L, stride);
  cp_async_commit();

  // the row's mask as bits, every word of every tile (bits past L clear)
  const unsigned char* mask = p.mask + static_cast<int64_t>(b) * L;
  for (int w = warp; w < 2 * n_tiles; w += kWarps) {
    const int key = w * 32 + lane;
    const bool valid = key < L && mask[key] != 0;
    const uint32_t bits = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) s_bits[w] = bits;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool any = t < n_tiles && (s_bits[2 * t] | s_bits[2 * t + 1]) != 0u;
      const uint32_t ballot = __ballot_sync(0xffffffffu, any);
      if (any) s_tiles[count + __popc(ballot & ((1u << lane) - 1u))] = t;
      count += __popc(ballot);
    }
    if (lane == 0) s_count = count;
  }
  __syncthreads();
  const bool uniform = s_count == 0;  // no valid key: the uniform softmax
  const int n_visit = uniform ? n_tiles : s_count;
  auto tile_of = [&](int i) { return uniform ? i : s_tiles[i]; };
  // the valid keys of tile t, a bit a key
  auto tile_bits = [&](int t) -> uint64_t {
    if (uniform) {
      const int in_range = L - t * kKTile;
      return in_range >= 64 ? ~0ull : (1ull << in_range) - 1ull;
    }
    return (static_cast<uint64_t>(s_bits[2 * t + 1]) << 32) | s_bits[2 * t];
  };
  auto issue = [&](int i) {
    const int t = tile_of(i);
    const unsigned dst = stage_addr + (i % 2) * Ly::kStageBytes;
    load_tile<T, D>(dst, k, t * kKTile, L, stride);
    load_tile<T, D>(dst + Ly::kTileBytes, v, t * kKTile, L, stride);
  };

  issue(0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  if constexpr (Ly::kMma) {
    // warp rows [16 warp, +16) of the tile; a lane's rows r0 = lane / 4
    // and r0 + 8, its columns (lane % 4) * 2 and + 1 of each 8-wide tile
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int row = 16 * warp + (lane % 8) + ((lane / 8) % 2) * 8;
      const int col = ks * 16 + (lane / 16) * 8;
      ldmatrix_x4(qf[ks], q_addr + row * Ly::kRowBytes + col * 2);
    }
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int i = 0; i < n_visit; ++i) {
      if (i + 1 < n_visit) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const unsigned k_addr = stage_addr + (i % 2) * Ly::kStageBytes;
      const unsigned v_addr = k_addr + Ly::kTileBytes;

      // S = Q K^T: 8 tiles of 8 keys
      float s[kKTile / 8][4];
#pragma unroll
      for (int j = 0; j < kKTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
        for (int jj = 0; jj < kKTile / 16; ++jj) {
          uint32_t kf[4];
          const int key = 16 * jj + (lane % 8) + (lane / 16) * 8;
          const int col = ks * 16 + ((lane / 8) % 2) * 8;
          ldmatrix_x4(kf, k_addr + key * Ly::kRowBytes + col * 2);
          mma_bf16(s[2 * jj], qf[ks], kf[0], kf[1]);
          mma_bf16(s[2 * jj + 1], qf[ks], kf[2], kf[3]);
        }
      }

      // scale, mask, and the rows' running max
      const uint64_t bits = tile_bits(tile_of(i));
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = (bits >> (8 * j + (lane % 4) * 2 + e)) & 1ull;
          s[j][e] = valid ? (uniform ? 0.f : s[j][e] * p.scale) : -INFINITY;
          s[j][2 + e] = valid ? (uniform ? 0.f : s[j][2 + e] * p.scale) : -INFINITY;
          x0 = fmaxf(x0, s[j][e]);
          x1 = fmaxf(x1, s[j][2 + e]);
        }
      }
#pragma unroll
      for (int offset = 1; offset < 4; offset <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, offset));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, offset));
      }
      float base0, base1;
      const float alpha0 = rescale(m0, x0, base0);
      const float alpha1 = rescale(m1, x1, base1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kKTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = exp2f((s[j][e] - base0) * kLog2e);
          s[j][2 + e] = exp2f((s[j][2 + e] - base1) * kLog2e);
          sum0 += s[j][e];
          sum1 += s[j][2 + e];
        }
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= alpha0;
        o[j][1] *= alpha0;
        o[j][2] *= alpha1;
        o[j][3] *= alpha1;
      }

      // O += P V: P's A fragments from the scores' accumulators
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int jd = 0; jd < D / 16; ++jd) {
          uint32_t vf[4];
          const int key = 16 * kk + (lane % 8) + ((lane / 8) % 2) * 8;
          const int col = 16 * jd + (lane / 16) * 8;
          ldmatrix_x4_trans(vf, v_addr + key * Ly::kRowBytes + col * 2);
          mma_bf16(o[2 * jd], pa, vf[0], vf[1]);
          mma_bf16(o[2 * jd + 1], pa, vf[2], vf[3]);
        }
      }
      __syncthreads();  // the stage is free for the tile after next
    }

#pragma unroll
    for (int offset = 1; offset < 4; offset <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, offset);
      l1 += __shfl_xor_sync(0xffffffffu, l1, offset);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const int row0 = q0 + 16 * warp + lane / 4;
    const int row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + (lane % 4) * 2;
      if (row0 < L) {
        *reinterpret_cast<uint32_t*>(out + row0 * stride + col) =
            pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
      }
      if (row1 < L) {
        *reinterpret_cast<uint32_t*>(out + row1 * stride + col) =
            pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
      }
    }
  } else {
    // fp32: thread = (query row tid / 2, half tid % 2 of the head dim)
    constexpr int kHalf = D / 2;
    // keys a softmax update (8 at D = 128, where 16 spill registers)
    constexpr int kChunk = D >= 128 ? 8 : 16;
    const int row = tid / 2;
    const int half = tid % 2;
    float qr[kHalf];
    const float* q_smem = reinterpret_cast<const float*>(smem + row * Ly::kRowBytes) + half * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(q_smem + d);
      qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    }
    float acc[kHalf];
#pragma unroll
    for (int d = 0; d < kHalf; ++d) acc[d] = 0.f;
    float m = -INFINITY, l = 0.f;

    for (int i = 0; i < n_visit; ++i) {
      if (i + 1 < n_visit) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const unsigned char* k_tile = smem + Ly::kQBytes + (i % 2) * Ly::kStageBytes;
      const unsigned char* v_tile = k_tile + Ly::kTileBytes;
      const uint64_t bits = tile_bits(tile_of(i));
      for (int c0 = 0; c0 < kKTile; c0 += kChunk) {
        float s[kChunk];
        float x = -INFINITY;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float* kr = reinterpret_cast<const float*>(k_tile + (c0 + c) * Ly::kRowBytes) +
                            half * kHalf;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < kHalf; d += 4) {
            const float4 y = *reinterpret_cast<const float4*>(kr + d);
            dot = fmaf(qr[d], y.x, dot);
            dot = fmaf(qr[d + 1], y.y, dot);
            dot = fmaf(qr[d + 2], y.z, dot);
            dot = fmaf(qr[d + 3], y.w, dot);
          }
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          const bool valid = (bits >> (c0 + c)) & 1ull;
          s[c] = valid ? (uniform ? 0.f : dot * p.scale) : -INFINITY;
          x = fmaxf(x, s[c]);
        }
        float base;
        const float alpha = rescale(m, x, base);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          s[c] = exp2f((s[c] - base) * kLog2e);
          sum += s[c];
        }
        l = l * alpha + sum;
#pragma unroll
        for (int d = 0; d < kHalf; ++d) acc[d] *= alpha;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float* vr = reinterpret_cast<const float*>(v_tile + (c0 + c) * Ly::kRowBytes) +
                            half * kHalf;
#pragma unroll
          for (int d = 0; d < kHalf; d += 4) {
            const float4 y = *reinterpret_cast<const float4*>(vr + d);
            acc[d] = fmaf(s[c], y.x, acc[d]);
            acc[d + 1] = fmaf(s[c], y.y, acc[d + 1]);
            acc[d + 2] = fmaf(s[c], y.z, acc[d + 2]);
            acc[d + 3] = fmaf(s[c], y.w, acc[d + 3]);
          }
        }
      }
      __syncthreads();  // the stage is free for the tile after next
    }

    const int q_row = q0 + row;
    if (q_row < L) {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      float* dst = reinterpret_cast<float*>(out) + q_row * stride + half * kHalf;
#pragma unroll
      for (int d = 0; d < kHalf; d += 4) {
        *reinterpret_cast<float4*>(dst + d) =
            make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) encoder_attention_kernel(const Params p) {
  attend<T, D>(p);
}

// Raise the instance's dynamic shared-memory cap to its layout, once a
// device: the default cap is 48 KB less the static arrays, which the
// bf16 D = 64 instance's 45 KB already passes.
template <typename T, int D>
cudaError_t allow_smem() {
  constexpr size_t smem = Layout<T, D>::kBytes;
  static bool allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(encoder_attention_kernel<T, D>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && device < kMaxDevices) allowed[device] = true;
  return err;
}

struct Launch {
  const Params& p;
  cudaStream_t stream;
  template <typename T, int D>
  cudaError_t run() const {
    const cudaError_t err = allow_smem<T, D>();
    if (err != cudaSuccess) return err;
    const dim3 grid((p.length + kQTile - 1) / kQTile, p.heads, p.batch);
    encoder_attention_kernel<T, D><<<grid, kThreads, Layout<T, D>::kBytes, stream>>>(p);
    return cudaGetLastError();
  }
};

struct Describe {
  int* smem_bytes;
  int* blocks_per_sm;
  template <typename T, int D>
  cudaError_t run() const {
    *smem_bytes = Layout<T, D>::kBytes;
    const cudaError_t err = allow_smem<T, D>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, reinterpret_cast<const void*>(encoder_attention_kernel<T, D>), kThreads,
        Layout<T, D>::kBytes);
  }
};

// dtype: 0 = float32, 1 = bfloat16
template <class Run>
cudaError_t dispatch(int dtype, int head_dim, const Run& r) {
  if (dtype == 0) {
    switch (head_dim) {
      case 16: return r.template run<float, 16>();
      case 64: return r.template run<float, 64>();
      case 128: return r.template run<float, 128>();
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (head_dim) {
      case 16: return r.template run<__nv_bfloat16, 16>();
      case 64: return r.template run<__nv_bfloat16, 64>();
      case 128: return r.template run<__nv_bfloat16, 128>();
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, out: [batch, length, heads, head_dim] of dtype (0 = float32,
// 1 = bfloat16), contiguous and 16-byte aligned; mask: [batch, length]
// bytes. Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a
// shape or dtype the kernel does not take.
int bat_encoder_attention(const void* q, const void* k, const void* v, const void* mask,
                          void* out, int batch, int length, int heads, int head_dim, int dtype,
                          float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || length <= 0 ||
      length > kMaxTiles * kKTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{q, k, v, static_cast<const unsigned char*>(mask), out, batch, length, heads,
                 scale};
  return static_cast<int>(dispatch(dtype, head_dim, Launch{p, static_cast<cudaStream_t>(stream)}));
}

// Dynamic shared memory of the (dtype, head_dim) instance, and how many of
// its blocks an SM holds.
int bat_describe(int dtype, int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return static_cast<int>(dispatch(dtype, head_dim, Describe{smem_bytes, blocks_per_sm}));
}

const char* bat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
