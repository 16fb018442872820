// Split-KV ragged paged attention for NVIDIA Hopper (sm_90a): the skeleton
// shared by K1 (paged_attention.cu, single-query decode) and K2
// (paged_attention_mq.cu, the multi-query speculative verify). K1 is the
// verify with T = 1.
//
// Contract (every implementation in client_tpu_torch/models/paged_attention.py):
//
//   out[b, t, h] = softmax_s(q[b, t, h] . K[s, h / g] * scale) . V[s, h / g]
//
// over the slots s <= positions[b, t] of sequence b. Slot s lives in
// physical block page_tables[b, s / bs] at offset s % bs of the pools
// k_pages, v_pages [N, bs, KV, D]; query head k*g + r reads KV head k.
// Running max, denominator and accumulator are fp32; the result is acc / l
// rounded once to q's dtype.
//
// What bounds it on this card: every visible K and V row of the batch is
// read once and scored against T*g query rows, ~4*T*g FLOPs per element
// read, far below the ~295 FLOP/byte where the H100's arithmetic becomes
// the limit. It is bound by device-memory bytes. The PR 1/PR 2 kernels gave
// one block to each (sequence, KV head): the longest context was walked by
// a single block, loads were 8 bytes a lane with one device-memory trip
// for K and another for V, and the verify scored every (row, slot) with a
// warp shuffle reduction. This design:
//
// - Splits the context (flash-decoding) inside one launch. Grid:
//   (partition of P slots, sequence x KV head, slice of kRows packed rows).
//   The host sizes the partition axis from the table width; a block whose
//   partition starts past the slice's last visible slot exits at once, so
//   `positions` is never read back to the host. A slice that fits one
//   partition writes `out` directly. Otherwise each block writes a partial
//   (m, l, acc[rows][D]) in fp32 to the caller's workspace, and the last
//   block to finish its (sequence, KV head, slice) -- found by an atomicAdd
//   on a per-unit counter after a __threadfence() -- merges the partials,
//   writes `out` and resets the counter to 0 for the next launch.
//   The counters assume ONE stream: two launches running at once on other
//   streams would share them. The serving engine issues every step on one
//   stream.
// - Stages pages through shared memory with cp.async (16-byte copies) in a
//   ring of two tiles of kTile slots (K and V together), so the next tile
//   is in flight while one is scored and accumulated. The rows'
//   positions, the partition's page table (resolved to pool rows in shared
//   memory, clamped like XLA's gather) and Q are read together before the
//   first barrier.
// - Scores without per-(row, slot) reductions. Packed row i of a slice is
//   verify row i / g of query head k*g + i % g. In bf16 one warp computes
//   S = K_tile . Q^T on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   accumulate; the tile's 32 slots as two M tiles, the packed rows as one
//   N tile, K read with ldmatrix, Q kept in registers) and updates every
//   row's online softmax from the accumulator fragments. Products of bf16
//   values are exact in fp32, so only the order of the sums differs from
//   the plain versions. fp32 scores on the CUDA cores, a warp a row and a
//   lane a slot (TF32 would break the 1e-5 checks). P.V accumulates in
//   fp32 on the CUDA cores (P is not rounded to bf16). Two barriers a tile.
// - Masking: a row may see no slot of a tile, of a partition or of a whole
//   block's work; its running max then stays -inf, the update is skipped
//   (no exp(-inf - -inf)), and the merge weighs it as exactly zero.
//   Padding rows repeat the lane's last position; a padding lane (table of
//   zeros, position 0) reads slot 0 of the trash block.
// - T, g, NB, bs and P are run-time arguments. D in {16, 32, 64, 128, 256}
//   and the dtype (fp32, bf16) pick K2's ten instances (kRows = 8 packed
//   rows a block; more are split over the grid); K1 also compiles the group
//   size (kRows = g in {1, 2, 4, 8}), 40 instances, so that it keeps no
//   accumulator for a row it does not have.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, attention_bench.py):
// at the long 7B shapes K1 reaches ~72 % and K2 ~59 % of their byte bound.
// What holds them there is the instructions a block issues per tile (copy
// issue, scoring, P.V: cutting them moved the time, the page layout and
// deeper pipelines did not) and the partitions' prologue and tail.
//
// The kernel allocates nothing and does not synchronise. The C entry points
// launch on the caller's stream and return cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace rpa {
// Everything here has internal linkage: K1's and K2's libraries each keep
// their own copy (a function-local static shared between the two loaded
// libraries would let one library's shared-memory setting stand for the
// other's kernel).
namespace {

constexpr int kThreads = 128;   // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;   // 16 resident warps an SM where shared memory allows
constexpr int kTile = 32;       // slots a pipeline stage holds
constexpr int kVec = 4;         // row elements one thread accumulates in P.V
constexpr int kMaxRows = 8;     // packed rows a block holds: one mma N tile
constexpr int kMaxParts = 256;  // partitions a launch may split a context into

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Everything a launch needs besides the instance's compile-time shape.
struct Params {
  const void* q;          // [B, T, H, D]
  const void* k_pages;    // [N, bs, KV, D]
  const void* v_pages;    // [N, bs, KV, D]
  const int* tables;      // [B, NB]
  const int* positions;   // [B, T]
  void* out;              // [B, T, H, D]
  float* workspace;       // partials, [B, KV, slices, parts, rows, D + 2]
  unsigned int* counters;  // [B x KV x slices], zero between launches
  int batch, rows, group, kv_heads, num_blocks, block_size, table_width, partition;
  float scale;
};

// Shape and shared-memory layout of one instance. Rows of a staged tile
// are padded by 16 bytes so that ldmatrix (bf16) and float4 reads (fp32)
// of 8 consecutive rows land on distinct banks.
template <typename T, int D, int kRows>
struct Layout {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies a row
  static constexpr int kTileBytes = kTile * kRowBytes;  // K or V of one stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  // two stages: measured faster than three on an H100 (PERF.md), since
  // more blocks then fit an SM
  static constexpr int kStages = 2;
  // copies: thread t moves chunk t % kChunks of rows t / kChunks + i * kRowStep
  static constexpr int kRowStep = kThreads / kChunks;
  static constexpr int kCopyIters = (kTile + kRowStep - 1) / kRowStep;
  // P.V: thread = (slot group, kVec columns)
  static constexpr int kDimGroups = D / kVec;
  static constexpr int kSlotGroups = kThreads / kDimGroups;
  static constexpr int kSlotsPer = kTile / kSlotGroups;
  static constexpr int kProbVec = kSlotsPer >= 4 ? 4 : kSlotsPer;
  // after the walk the ring holds the slot groups' accumulators, then the
  // merge weights (kMaxParts x kRows floats)
  static constexpr int kPipeBytes =
      cmax(cmax(kStages * kStageBytes, kSlotGroups * kRows * D * 4), kMaxParts * kRows * 4);
  static constexpr int kQBytes = kMma ? 0 : kRows * D * 4;  // fp32 scores read Q from here
  static constexpr int kScoreBytes = kRows * kTile * 4;
  // alpha, m, l (floats) and limit (ints) a row, padded to 16 bytes, and a flag
  static constexpr int kRowStateBytes = (16 * kRows + 15) / 16 * 16;
  static constexpr int kFixedBytes = kPipeBytes + kQBytes + kScoreBytes + kRowStateBytes + 16;
  static size_t bytes(int partition) { return kFixedBytes + 4 * static_cast<size_t>(partition); }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// N (2 or 4) contiguous elements widened to fp32, in one load
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  static_assert(N == 2 || N == 4, "two or four elements");
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&out)[N]) {
  static_assert(N == 2 || N == 4, "two or four elements");
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
  } else {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x; out[1] = v.y;
  }
}

template <int N>
__device__ __forceinline__ void load_probs(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  }
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  }
  return x;
}

// One block: partition blockIdx.x of (sequence, KV head) blockIdx.y, packed
// rows [blockIdx.z * kRows, +kRows).
template <typename T, int D, int kRows>
__device__ __forceinline__ void split_attention(const Params& p) {
  using L = Layout<T, D, kRows>;
  static_assert(kRows >= 1 && kRows <= kMaxRows, "the packed rows fill one mma N tile");
  static_assert(kTile == 32, "the scoring warp covers a tile as two 16-slot mma tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_red = reinterpret_cast<float*>(smem);  // once the walk is done
  float* s_q = reinterpret_cast<float*>(smem + L::kPipeBytes);
  float* s_score = reinterpret_cast<float*>(smem + L::kPipeBytes + L::kQBytes);  // [row][slot]
  float* s_alpha = s_score + kRows * kTile;
  float* s_m = s_alpha + kRows;
  float* s_l = s_m + kRows;
  int* s_limit = reinterpret_cast<int*>(s_l + kRows);
  int* s_flag = reinterpret_cast<int*>(smem + L::kFixedBytes - 16);
  int* s_row = s_flag + 4;  // [partition slot]
  const unsigned pipe = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k_pages = static_cast<const T*>(p.k_pages);
  const T* __restrict__ v_pages = static_cast<const T*>(p.v_pages);
  T* __restrict__ out = static_cast<T*>(p.out);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int part = blockIdx.x;
  const int n_parts = gridDim.x;
  const int b = blockIdx.y / p.kv_heads;
  const int kvh = blockIdx.y % p.kv_heads;
  const int unit = blockIdx.y * gridDim.z + blockIdx.z;  // (b, kvh, slice)
  const int first = blockIdx.z * kRows;
  const int packed = p.rows * p.group;
  const int n_rows = packed - first < kRows ? packed - first : kRows;
  const int r_stride = packed < kRows ? packed : kRows;  // rows of one partial
  const int heads = p.kv_heads * p.group;
  const int span = p.table_width * p.block_size;

  // element offset of packed row n in q and out ([B, T, H, D] both)
  auto row_offset = [&](int n) -> int64_t {
    const int pr = first + n;
    return ((static_cast<int64_t>(b) * p.rows + pr / p.group) * heads + kvh * p.group +
            pr % p.group) *
           D;
  };

  // Three independent reads, issued before one barrier: the rows'
  // positions, the partition's page table and Q.
  // Row n sees slots [0, limit[n]); the table covers span slots.
  if (tid < kRows) {
    int limit = 0;
    if (tid < n_rows) {
      limit = p.positions[static_cast<int64_t>(b) * p.rows + (first + tid) / p.group] + 1;
      limit = limit < span ? limit : span;
    }
    s_limit[tid] = limit;
  }
  // the partition's slots resolved to pool rows, clamped like XLA's gather
  const int p0 = part * p.partition;
  const int p_slots = span - p0 < p.partition ? span - p0 : p.partition;
  const int* table = p.tables + static_cast<int64_t>(b) * p.table_width;
  for (int j = tid; j < p_slots; j += kThreads) {
    const int s = p0 + j;
    int phys = table[s / p.block_size];
    phys = phys < 0 ? 0 : (phys >= p.num_blocks ? p.num_blocks - 1 : phys);
    s_row[j] = phys * p.block_size + s % p.block_size;
  }
  // bf16: warp 0 scores; lane l holds Q row l / 4 as mma B fragments
  uint32_t qf[L::kMma ? D / 16 : 1][2];
  if constexpr (L::kMma) {
    const int n = lane / 4;
    const bool live = warp == 0 && n < n_rows;
    const T* q_row = q + (live ? row_offset(n) : 0) + (lane % 4) * 2;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qf[ks][0] = live ? *reinterpret_cast<const uint32_t*>(q_row + ks * 16) : 0u;
      qf[ks][1] = live ? *reinterpret_cast<const uint32_t*>(q_row + ks * 16 + 8) : 0u;
    }
  } else {
    for (int j = tid; j < n_rows * D; j += kThreads) {
      s_q[j] = to_float(q[row_offset(j / D) + j % D]);
    }
  }
  __syncthreads();
  int walk = 1;  // at least slot 0, so that block 0 always writes the output
#pragma unroll
  for (int n = 0; n < kRows; ++n) walk = s_limit[n] > walk ? s_limit[n] : walk;
  if (p0 >= walk) return;  // uniform: past the slice's last visible slot
  const int n_work = (walk + p.partition - 1) / p.partition;
  const int n_slots = walk - p0 < p.partition ? walk - p0 : p.partition;
  const int n_tiles = (n_slots + kTile - 1) / kTile;
  const int t_end = p0 + n_slots;

  // thread t copies 16-byte chunk t % kChunks of tile rows
  // t / kChunks + i * kRowStep, of K and of V
  const int64_t slot_stride = static_cast<int64_t>(p.kv_heads) * D;
  const int64_t chunk_offset =
      static_cast<int64_t>(kvh) * D + (tid % L::kChunks) * (16 / static_cast<int>(sizeof(T)));
  const int copy_row = tid / L::kChunks;
  const unsigned copy_dst = pipe + copy_row * L::kRowBytes + (tid % L::kChunks) * 16;
  auto issue = [&](int tile) {
    const unsigned stage = copy_dst + (tile % L::kStages) * L::kStageBytes;
#pragma unroll
    for (int it = 0; it < L::kCopyIters; ++it) {
      const int j = copy_row + it * L::kRowStep;
      if (L::kRowStep * L::kCopyIters == kTile || j < kTile) {
        const int local = tile * kTile + j;
        const bool live = local < n_slots;
        const int64_t src = live ? s_row[local] * slot_stride + chunk_offset : 0;
        const unsigned dst = stage + it * L::kRowStep * L::kRowBytes;
        cp_async16(dst, k_pages + src, live);
        cp_async16(dst + L::kTileBytes, v_pages + src, live);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // Each row's running max and denominator live in the warp that scores
  // it: bf16, warp 0, rows 2 (lane % 4) + {0, 1}; fp32, rows warp + 4 j.
  constexpr int kOwned = L::kMma ? 2 : (kRows + kWarps - 1) / kWarps;
  float m_run[kOwned];
  float l_run[kOwned];
#pragma unroll
  for (int j = 0; j < kOwned; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }
  float acc[kRows][kVec];
#pragma unroll
  for (int n = 0; n < kRows; ++n) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[n][c] = 0.f;
  }
  const int col = (tid % L::kDimGroups) * kVec;
  const int sg = tid / L::kDimGroups;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // tile i is in; every thread is done with tile i - 1
    if (i + L::kStages - 1 < n_tiles) issue(i + L::kStages - 1);
    cp_async_commit();
    const int stage = (i % L::kStages) * L::kStageBytes;
    const int t0 = p0 + i * kTile;

    // 1. scores of the tile's 32 slots and the online softmax update of
    // each row, in the warp that owns the row: p goes to s_score, the
    // rescale of the row's accumulator to s_alpha
    if constexpr (L::kMma) {
      if (warp == 0) {
        float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const unsigned a_src = pipe + stage + (lane % 16) * L::kRowBytes + (lane / 16) * 16;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, a_src + mt * 16 * L::kRowBytes + ks * 32);
            mma_bf16(c[mt], a, qf[ks][0], qf[ks][1]);
          }
        }
        // c[mt][e]: slot 16 mt + lane / 4 + 8 (e / 2), row 2 (lane % 4) + e % 2
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = (lane % 4) * 2 + r;
          const int limit = n < kRows ? s_limit[n] : 0;
          float sc[4];
          float big = -INFINITY;
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int slot = (k4 / 2) * 16 + lane / 4 + (k4 % 2) * 8;
            const bool seen = t0 + slot < limit && t0 + slot < t_end;
            sc[k4] = seen ? c[k4 / 2][(k4 % 2) * 2 + r] * p.scale : -INFINITY;
            big = fmaxf(big, sc[k4]);
          }
          // the lanes that share lane % 4 hold the row's 32 slots
#pragma unroll
          for (int offset = 4; offset < 32; offset <<= 1) {
            big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, offset));
          }
          const float m_new = fmaxf(m_run[r], big);
          // no slot of this row seen yet: its state stays empty
          // (exp(-inf - -inf) would be NaN)
          const bool empty = m_new == -INFINITY;
          const float alpha = empty ? 1.f : expf(m_run[r] - m_new);  // 0 when m_run = -inf
          float prob[4];
          float sum = 0.f;
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            prob[k4] = empty ? 0.f : expf(sc[k4] - m_new);  // 0 for a masked slot
            sum += prob[k4];
          }
#pragma unroll
          for (int offset = 4; offset < 32; offset <<= 1) {
            sum += __shfl_xor_sync(0xffffffffu, sum, offset);
          }
          l_run[r] = l_run[r] * alpha + sum;
          m_run[r] = m_new;
          if (n < kRows) {
#pragma unroll
            for (int k4 = 0; k4 < 4; ++k4) {
              s_score[n * kTile + (k4 / 2) * 16 + lane / 4 + (k4 % 2) * 8] = prob[k4];
            }
            if (lane < 4) s_alpha[n] = alpha;
          }
        }
      }
    } else {
      // fp32 on the CUDA cores: lane = slot, warp w scores rows w + 4 j
      const float* k_row = reinterpret_cast<const float*>(smem + stage + lane * L::kRowBytes);
#pragma unroll
      for (int j = 0; j < kOwned; ++j) {
        const int n = warp + j * kWarps;
        if (n < n_rows) {
          const float* q_row = s_q + n * D;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(k_row + d);
            const float4 qq = *reinterpret_cast<const float4*>(q_row + d);
            dot = fmaf(qq.x, kk.x, dot);
            dot = fmaf(qq.y, kk.y, dot);
            dot = fmaf(qq.z, kk.z, dot);
            dot = fmaf(qq.w, kk.w, dot);
          }
          const bool seen = t0 + lane < s_limit[n] && t0 + lane < t_end;
          const float sc = seen ? dot * p.scale : -INFINITY;
          const float m_new = fmaxf(m_run[j], warp_max(sc));
          const bool empty = m_new == -INFINITY;  // uniform across the warp
          const float alpha = empty ? 1.f : expf(m_run[j] - m_new);
          const float prob = empty ? 0.f : expf(sc - m_new);
          l_run[j] = l_run[j] * alpha + warp_sum(prob);
          m_run[j] = m_new;
          s_score[n * kTile + lane] = prob;
          if (lane == 0) s_alpha[n] = alpha;
        }
      }
    }
    __syncthreads();

    // 2. P.V in fp32: this thread's kVec columns over its slot group
    const T* v_tile = reinterpret_cast<const T*>(smem + stage + L::kTileBytes);
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      if (n < n_rows) {
        const float alpha = s_alpha[n];
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[n][c] *= alpha;
      }
    }
#pragma unroll
    for (int j0 = 0; j0 < L::kSlotsPer; j0 += L::kProbVec) {
      const int slot0 = sg * L::kSlotsPer + j0;
      float v[L::kProbVec][kVec];
#pragma unroll
      for (int u = 0; u < L::kProbVec; ++u) {
        load_vec(v_tile + (slot0 + u) * (L::kRowBytes / static_cast<int>(sizeof(T))) + col, v[u]);
      }
#pragma unroll
      for (int n = 0; n < kRows; ++n) {
        if (n < n_rows) {
          float prob[L::kProbVec];
          load_probs(s_score + n * kTile + slot0, prob);
#pragma unroll
          for (int u = 0; u < L::kProbVec; ++u) {
#pragma unroll
            for (int c = 0; c < kVec; ++c) acc[n][c] = fmaf(prob[u], v[u][c], acc[n][c]);
          }
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it now holds the slot groups' sums
#pragma unroll
  for (int n = 0; n < kRows; ++n) {
    if (n < n_rows) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) s_red[(sg * kRows + n) * D + col + c] = acc[n][c];
    }
  }
  if constexpr (L::kMma) {
    if (warp == 0 && lane < 4) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = lane * 2 + r;
        if (n < n_rows) {
          s_m[n] = m_run[r];
          s_l[n] = l_run[r];
        }
      }
    }
  } else if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      const int n = warp + j * kWarps;
      if (n < n_rows) {
        s_m[n] = m_run[j];
        s_l[n] = l_run[j];
      }
    }
  }
  __syncthreads();

  const bool direct = n_work == 1;
  const int part_floats = r_stride * (D + 2);  // m[rows], l[rows], acc[rows][D]
  // (the workspace is untouched, and may be null, when the slice fits one partition)
  float* const parts =
      direct ? nullptr : p.workspace + static_cast<int64_t>(unit) * n_parts * part_floats;
  float* const partial = direct ? nullptr : parts + static_cast<int64_t>(part) * part_floats;
  for (int e = tid; e < n_rows * D; e += kThreads) {
    const int n = e / D;
    const int d = e % D;
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < L::kSlotGroups; ++g) sum += s_red[(g * kRows + n) * D + d];
    if (direct) {
      // l = 0 only for a row with no visible slot (a position < 0, which
      // the engine never sends): zeros, not NaN
      const float l = s_l[n];
      from_float(l > 0.f ? sum / l : 0.f, out + row_offset(n) + d);
    } else {
      partial[2 * r_stride + n * D + d] = sum;
    }
  }
  if (direct) return;
  if (tid < n_rows) {
    partial[tid] = s_m[tid];
    partial[r_stride + tid] = s_l[tid];
  }
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) {
    *s_flag = atomicAdd(p.counters + unit, 1u) == static_cast<unsigned>(n_work - 1);
  }
  __syncthreads();
  if (!*s_flag) return;
  __threadfence();

  // the last block merges: out = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M);
  // a partial that saw nothing of a row has m = -inf and weighs zero
  float* s_weight = s_red;  // [n_work][kRows]
  if (tid < n_rows) {
    float big = -INFINITY;
    for (int w = 0; w < n_work; ++w) big = fmaxf(big, __ldcg(parts + w * part_floats + tid));
    s_m[tid] = big;
  }
  __syncthreads();
  for (int e = tid; e < n_work * n_rows; e += kThreads) {
    const int w = e / n_rows;
    const int n = e % n_rows;
    const float m = __ldcg(parts + w * part_floats + n);
    s_weight[w * kRows + n] = m == -INFINITY ? 0.f : expf(m - s_m[n]);
  }
  __syncthreads();
  if (tid < n_rows) {
    float den = 0.f;
    for (int w = 0; w < n_work; ++w) {
      den += s_weight[w * kRows + tid] * __ldcg(parts + w * part_floats + r_stride + tid);
    }
    s_l[tid] = den;
  }
  __syncthreads();
  for (int e = tid; e < n_rows * D; e += kThreads) {
    const int n = e / D;
    const int d = e % D;
    float num = 0.f;
    for (int w = 0; w < n_work; ++w) {
      num += s_weight[w * kRows + n] * __ldcg(parts + w * part_floats + 2 * r_stride + n * D + d);
    }
    const float den = s_l[n];
    from_float(den > 0.f ? num / den : 0.f, out + row_offset(n) + d);
  }
  if (tid == 0) p.counters[unit] = 0u;  // ready for the next launch
}

// Raise the instance's dynamic shared-memory cap to at least `smem` bytes
// (above 48 KB it has to be asked for); the cap only ever grows.
template <typename T, int D, int kRows>
cudaError_t allow_smem(void (*kernel)(Params), size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// Launch one instance: grid (partitions, B x KV, row slices).
template <typename T, int D, int kRows>
cudaError_t launch(void (*kernel)(Params), const Params& p, long long workspace_floats,
                   int counter_count, cudaStream_t stream) {
  using L = Layout<T, D, kRows>;
  const int packed = p.rows * p.group;
  const int slices = (packed + kRows - 1) / kRows;
  const int span = p.table_width * p.block_size;
  const int parts = (span + p.partition - 1) / p.partition;
  const long long units = static_cast<long long>(p.batch) * p.kv_heads * slices;
  if (parts > kMaxParts || static_cast<long long>(p.batch) * p.kv_heads > 65535 ||
      slices > 65535) {
    return cudaErrorInvalidValue;
  }
  if (parts > 1) {
    const long long need =
        units * parts * (packed < kRows ? packed : kRows) * static_cast<long long>(D + 2);
    if (p.workspace == nullptr || workspace_floats < need || p.counters == nullptr ||
        counter_count < units) {
      return cudaErrorInvalidValue;
    }
  }
  const size_t smem = L::bytes(p.partition);
  const cudaError_t err = allow_smem<T, D, kRows>(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(parts, p.batch * p.kv_heads, slices), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Dynamic shared memory and resident blocks an SM of one instance.
template <typename T, int D, int kRows>
cudaError_t describe(void (*kernel)(Params), int partition, int* smem_bytes,
                     int* blocks_per_sm) {
  const size_t smem = Layout<T, D, kRows>::bytes(partition);
  *smem_bytes = static_cast<int>(smem);
  const cudaError_t err = allow_smem<T, D, kRows>(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(kernel), kThreads, smem);
}

// K names the kernel: K::kernel<T, D, R>() is its instance for (dtype,
// head dim, packed rows a block); K::kRowsFromGroup says whether R is the
// group size (K1) or always kMaxRows (K2). `run` launches or describes.
struct Launch {
  const Params& p;
  long long workspace_floats;
  int counter_count;
  cudaStream_t stream;
  template <typename T, int D, int R>
  cudaError_t operator()(void (*kernel)(Params)) const {
    return launch<T, D, R>(kernel, p, workspace_floats, counter_count, stream);
  }
};
struct Describe {
  int partition;
  int* smem_bytes;
  int* blocks_per_sm;
  template <typename T, int D, int R>
  cudaError_t operator()(void (*kernel)(Params)) const {
    return describe<T, D, R>(kernel, partition, smem_bytes, blocks_per_sm);
  }
};

template <class K, typename T, int D, class Run>
cudaError_t dispatch_rows(int rows, const Run& run) {
  if constexpr (K::kRowsFromGroup) {
    switch (rows) {
      case 1: return run.template operator()<T, D, 1>(K::template kernel<T, D, 1>());
      case 2: return run.template operator()<T, D, 2>(K::template kernel<T, D, 2>());
      case 4: return run.template operator()<T, D, 4>(K::template kernel<T, D, 4>());
      case 8: return run.template operator()<T, D, 8>(K::template kernel<T, D, 8>());
      default: return cudaErrorInvalidValue;
    }
  } else {
    return run.template operator()<T, D, kMaxRows>(K::template kernel<T, D, kMaxRows>());
  }
}

template <class K, typename T, class Run>
cudaError_t dispatch_dim(int head_dim, int rows, const Run& run) {
  switch (head_dim) {
    case 16: return dispatch_rows<K, T, 16>(rows, run);
    case 32: return dispatch_rows<K, T, 32>(rows, run);
    case 64: return dispatch_rows<K, T, 64>(rows, run);
    case 128: return dispatch_rows<K, T, 128>(rows, run);
    case 256: return dispatch_rows<K, T, 256>(rows, run);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16; rows: the instance's packed rows a
// block (K1: the group size; ignored by K2)
template <class K, class Run>
cudaError_t dispatch(int dtype, int head_dim, int rows, const Run& run) {
  if (dtype == 0) return dispatch_dim<K, float>(head_dim, rows, run);
  if (dtype == 1) return dispatch_dim<K, __nv_bfloat16>(head_dim, rows, run);
  return cudaErrorInvalidValue;
}

// Check the run-time shape, then launch the (dtype, D, rows) instance.
template <class K>
cudaError_t run(int dtype, int head_dim, const Params& p, long long workspace_floats,
                int counter_count, cudaStream_t stream) {
  if (p.batch <= 0 || p.rows <= 0 || p.group <= 0 || p.kv_heads <= 0 || p.block_size <= 0 ||
      p.table_width <= 0 || p.num_blocks <= 0 || p.partition <= 0) {
    return cudaErrorInvalidValue;
  }
  return dispatch<K>(dtype, head_dim, p.group,
                     Launch{p, workspace_floats, counter_count, stream});
}

}  // namespace
}  // namespace rpa
