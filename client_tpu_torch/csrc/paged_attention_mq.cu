// Multi-query ragged paged attention (the speculative verify) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_rpa_kernel_mq` launched by
// `paged_attention_pallas_mq` in client_tpu/models/paged_attention.py.
//
// Contract (the same as every `*_mq` implementation in
// client_tpu_torch/models/paged_attention.py):
//
//   out[b, t, h] = softmax_s(q[b, t, h] . K[s, h / g] * scale) . V[s, h / g]
//
// over the slots s <= positions[b, t] of sequence b: verify row t sees its
// own speculative prefix and nothing after it. Slot s lives in physical
// block page_tables[b, s / bs] at offset s % bs of the pools k_pages,
// v_pages [N, bs, KV, D]; query head k*g + r reads KV head k. Running max,
// denominator and accumulator are fp32; the result is acc / l cast to q's
// dtype.
//
// What bounds it on this card: like the single-query decode kernel
// (paged_attention.cu), the verify reads every valid K and V row of the
// batch and does ~4*T*g FLOPs per element read (T verify rows, g query
// heads per KV head): for T*g <= 40 that is far below the ~295 FLOP/byte
// at which the H100's arithmetic becomes the limit. It is bound by
// device-memory bytes, and the design aims at reading each K/V row once
// for all T rows of a sequence (the point of a batched verify: T
// sequential decode launches would read the pages T times):
//
// - One thread block per (sequence, KV head, row slice). The block packs
//   the T*g query rows of its (sequence, KV head) -- packed row i is
//   verify row i / g of query head k*g + i % g -- and scores every K/V row
//   it loads against every packed row. At most kRows rows live in one
//   block (registers: a lane holds kRows x D/32 query values and as many
//   accumulators); more rows are split over the grid's third axis, and
//   each slice then reads the pages again. The serving engine's verify
//   at Llama-7B widths (T <= 5, g = 1) fits one slice.
// - The TPU grid's sequential block axis becomes a loop inside the block
//   that stops at the slice's largest positions[b, t] + 1; the mask is
//   per row. Each warp walks its own chunks of kChunk consecutive slots
//   and keeps a private online softmax per row; the warps' states are
//   merged once at the end through shared memory.
// - A row may see no slot of a whole chunk (the chunk lies past its
//   position but inside a later row's range), and a warp may see no slot
//   of a row at all. Its running max then stays -inf, and the update is
//   skipped rather than computing exp(-inf - -inf) = NaN; the merge
//   weighs a warp that saw nothing as exactly zero.
// - A lane holds D/32 contiguous elements of a row and loads them as one
//   vector; a warp issues the K and V rows of a whole chunk (2 x kChunk
//   loads in flight) before it reduces any of them.
// - T, g, NB and bs are runtime arguments; only D and the dtype pick a
//   compiled instance (D in {16, 32, 64, 128, 256}, fp32 or bf16).
//
// Measured on an H100 (PERF.md): this first version is not limited by
// bytes but by its per-(row, slot) warp reductions and by one block walking
// a whole long sequence; scoring the packed rows with lanes over slots and
// splitting long contexts across blocks are the next steps.
//
// The kernel allocates nothing and does not synchronise. The C entry point
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kChunk = 4;  // consecutive slots a warp loads before reducing

// Packed query rows one block holds, and its warps: the per-lane state is
// kRows x D/32 query values plus as many accumulators, and the merge
// buffer is warps x kRows x D floats of shared memory (32 KiB at most).
__host__ __device__ constexpr int rows_for(int head_dim) {
  return head_dim <= 128 ? 8 : 4;
}
__host__ __device__ constexpr int warps_for(int head_dim) {
  return head_dim <= 128 ? 8 : 4;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

template <int BYTES>
struct RawVec;
template <>
struct RawVec<2> {
  using type = unsigned short;
};
template <>
struct RawVec<4> {
  using type = unsigned int;
};
template <>
struct RawVec<8> {
  using type = uint2;
};
template <>
struct RawVec<16> {
  using type = uint4;
};

// Load N contiguous elements of T starting at p (aligned to their total
// size, or to 16 bytes when larger) and widen them to fp32.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kPiece = kBytes >= 16 ? 16 : kBytes;
  constexpr int kPieces = kBytes / kPiece;
  constexpr int kPerPiece = kPiece / static_cast<int>(sizeof(T));
  using Raw = typename RawVec<kPiece>::type;
  const Raw* src = reinterpret_cast<const Raw*>(p);
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    Raw raw = src[c];
    const T* elems = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPerPiece; ++i) out[c * kPerPiece + i] = to_float(elems[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  }
  return x;
}

// Everything a launch needs besides the instance's compile-time shape.
struct Args {
  const void* q;          // [B, T, H, D]
  const void* k_pages;    // [N, bs, KV, D]
  const void* v_pages;    // [N, bs, KV, D]
  const int* tables;      // [B, NB]
  const int* positions;   // [B, T]
  void* out;              // [B, T, H, D]
  int batch, rows, group, kv_heads, num_blocks, block_size, table_width;
  float scale;
  cudaStream_t stream;
};

// One block per (sequence b = blockIdx.x, KV head k = blockIdx.y, row
// slice blockIdx.z). D = head dim. A lane holds EPL = ceil(D/32)
// contiguous elements of a row; for D < 32 the upper lanes hold none. The
// launch bounds name a minimum of one block per SM: without it ptxas caps
// the small head dims at 64 registers and spills.
template <typename T, int D>
__global__ void __launch_bounds__(warps_for(D) * 32, 1)
rpa_decode_mq_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages, const int* __restrict__ tables,
                     const int* __restrict__ positions, T* __restrict__ out,
                     int rows, int group, int kv_heads, int num_blocks,
                     int block_size, int table_width, float scale) {
  constexpr int EPL = D < 32 ? 1 : D / 32;
  constexpr int kRows = rows_for(D);
  constexpr int kWarps = warps_for(D);
  constexpr int kThreads = kWarps * 32;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int first = blockIdx.z * kRows;  // first packed row of this slice
  const int packed = rows * group;
  const int n_rows = packed - first < kRows ? packed - first : kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool active = lane * EPL < D;
  const int col = active ? lane * EPL : 0;
  const int heads = kv_heads * group;

  __shared__ float s_max[kWarps][kRows];
  __shared__ float s_sum[kWarps][kRows];
  __shared__ float s_acc[kWarps][kRows][D];

  // packed row i of the slice: verify row (first + i) / group of query
  // head kvh * group + (first + i) % group; its element offset into q and
  // out, which share the [B, T, H, D] layout
  auto row_offset = [&](int i) -> int64_t {
    const int p = first + i;
    const int t = p / group;
    return ((static_cast<int64_t>(b) * rows + t) * heads + kvh * group + p % group) * D;
  };

  // row i sees slots 0 .. n_valid[i]-1 (slot <= positions[b, t]); the
  // table covers table_width * block_size slots, and slots past it do not
  // exist. The walk covers the slice's longest row.
  const int span = table_width * block_size;
  int n_valid[kRows];
  int n_walk = 0;
  float qr[kRows][EPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    n_valid[i] = 0;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[i][e] = 0.f;
    if (i < n_rows) {
      int n = positions[static_cast<int64_t>(b) * rows + (first + i) / group] + 1;
      n = n > span ? span : n;
      n_valid[i] = n;
      n_walk = n > n_walk ? n : n_walk;
      if (active) load_row<T, EPL>(q + row_offset(i) + col, qr[i]);
    }
  }

  float m[kRows], l[kRows], acc[kRows][EPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }

  const int* table = tables + static_cast<int64_t>(b) * table_width;
  const int64_t slot_stride = static_cast<int64_t>(kv_heads) * D;  // one slot
  const int n_chunks = (n_walk + kChunk - 1) / kChunk;

  for (int c = warp; c < n_chunks; c += kWarps) {
    const int s0 = c * kChunk;
    // issue every K and V row of the chunk, then reduce
    float kr[kChunk][EPL];
    float vr[kChunk][EPL];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int s = s0 + t;
      if (active && s < n_walk) {
        int phys = table[s / block_size];
        // XLA's gather clamps an out-of-range index; do the same rather
        // than read outside the pool
        phys = phys < 0 ? 0 : (phys >= num_blocks ? num_blocks - 1 : phys);
        const int64_t row = (static_cast<int64_t>(phys) * block_size + s % block_size) *
                                slot_stride +
                            static_cast<int64_t>(kvh) * D + col;
        load_row<T, EPL>(k_pages + row, kr[t]);
        load_row<T, EPL>(v_pages + row, vr[t]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kr[t][e] = 0.f;
          vr[t][e] = 0.f;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= n_rows) continue;  // uniform across the block
      float p[kChunk];
      float m_new = m[i];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        float partial = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) partial += qr[i][e] * kr[t][e];
        const float score = warp_sum(partial) * scale;
        p[t] = (s0 + t < n_valid[i]) ? score : -INFINITY;
        m_new = fmaxf(m_new, p[t]);
      }
      // no slot of this row seen yet, in this chunk or before it: its
      // state stays empty (exp(-inf - -inf) would be NaN). Uniform across
      // the warp: every lane holds the same reduced scores.
      if (m_new == -INFINITY) continue;
      const float alpha = expf(m[i] - m_new);  // 0 when m[i] = -inf
      float chunk_sum = 0.f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        p[t] = (s0 + t < n_valid[i]) ? expf(p[t] - m_new) : 0.f;
        chunk_sum += p[t];
      }
      l[i] = l[i] * alpha + chunk_sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float sum = acc[i][e] * alpha;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) sum += p[t] * vr[t][e];
        acc[i][e] = sum;
      }
    }
  }

  // merge the warps' states: out = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (lane == 0) {
      s_max[warp][i] = m[i];
      s_sum[warp][i] = l[i];
    }
    if (active) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) s_acc[warp][i][col + e] = acc[i][e];
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < n_rows * D; j += kThreads) {
    const int i = j / D;
    const int d = j % D;
    float big = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, s_max[w][i]);
    float num = 0.f;
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no slot of this row has m = -inf and weighs zero
      const float weight = s_max[w][i] == -INFINITY ? 0.f : expf(s_max[w][i] - big);
      num += s_acc[w][i][d] * weight;
      den += s_sum[w][i] * weight;
    }
    // n_valid <= 0 cannot come from the engine; write zeros, not NaN
    const float value = den > 0.f ? num / den : 0.f;
    from_float(value, out + row_offset(i) + d);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a) {
  constexpr int kRows = rows_for(D);
  const int slices = (a.rows * a.group + kRows - 1) / kRows;
  const dim3 grid(a.batch, a.kv_heads, slices);
  rpa_decode_mq_kernel<T, D><<<grid, warps_for(D) * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), a.tables, a.positions,
      static_cast<T*>(a.out), a.rows, a.group, a.kv_heads, a.num_blocks,
      a.block_size, a.table_width, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    case 256: return launch<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; rows = T, the verify rows of each
// sequence. Returns a cudaError_t (0 = success); cudaErrorInvalidValue for
// a head_dim / dtype with no compiled instance (the Python wrapper rejects
// those before calling).
int rpa_decode_mq(const void* q, const void* k_pages, const void* v_pages,
                  const int* page_tables, const int* positions, void* out,
                  int batch, int rows, int heads, int kv_heads, int head_dim,
                  int num_blocks, int block_size, int table_width, int dtype,
                  float scale, void* stream) {
  if (batch <= 0 || rows <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      block_size <= 0 || table_width <= 0 || num_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{q, k_pages, v_pages, page_tables, positions, out,
                  batch, rows, heads / kv_heads, kv_heads, num_blocks,
                  block_size, table_width, scale,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_dim<float>(head_dim, args);
  } else if (dtype == 1) {
    err = dispatch_dim<__nv_bfloat16>(head_dim, args);
  }
  return static_cast<int>(err);
}

const char* rpa_mq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
