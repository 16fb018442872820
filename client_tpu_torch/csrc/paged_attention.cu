// Ragged paged-attention decode for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_rpa_kernel` launched by
// `paged_attention_pallas` in client_tpu/models/paged_attention.py.
//
// Contract (the same as every implementation in
// client_tpu_torch/models/paged_attention.py):
//
//   out[b, h] = softmax_s(q[b, h] . K[s, h / g] * scale) . V[s, h / g]
//
// over the slots s <= positions[b] of sequence b, where slot s lives in
// physical block page_tables[b, s / bs] at offset s % bs of the pools
// k_pages, v_pages [N, bs, KV, D]; g = H / KV query heads share one KV
// head (query head k*g + r reads KV head k). Running max, denominator and
// accumulator are fp32; the result is acc / l cast to q's dtype.
//
// What bounds it on this card: decode attention reads every valid K and V
// row of the batch once and does ~4*g FLOPs per element read, far below
// the ~295 FLOP/byte the H100 needs before its arithmetic is the limit.
// It is bound by device-memory bytes. The design therefore aims at
// reading each K/V row exactly once and keeping many loads in flight:
//
// - One thread block per (sequence, KV head). The g query heads of the
//   group live in registers and share every K/V row the block loads, so
//   a row crosses device memory once for the whole group.
// - The TPU grid's sequential block axis becomes a loop inside the block,
//   and it stops at positions[b]: slots past it add exactly zero in the
//   reference, so they are never read. Each of the block's warps walks
//   its own chunks of kChunk consecutive slots and keeps a private online
//   softmax; the warps' states are merged once at the end through shared
//   memory (the TPU kernel carried one state across sequential grid
//   steps; here nothing carries over between blocks or warps).
// - A lane holds D/32 contiguous elements of a row and loads them as one
//   vector; a warp issues all kChunk rows of a chunk before it reduces any
//   of them, so each warp keeps kChunk loads in flight.
// - NB and bs are runtime arguments, and D and g pick a compiled instance
//   (D in {16, 32, 64, 128, 256}, g in {1, 2, 4, 8}): the serving engine
//   changes NB, its ragged page-table bucket, every step.
//
// The kernel allocates nothing and does not synchronise. The C entry point
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kChunk = 8;  // consecutive slots a warp loads before reducing

// Warps per block: 16 for one 128-wide head, fewer as the group's merge
// buffer (warps x g x D floats of shared memory) grows. More warps shorten
// the serial walk of the longest sequence, which bounds the whole launch.
__host__ __device__ constexpr int warps_for(int group, int head_dim) {
  return group * head_dim <= 128 ? 16 : (group * head_dim <= 256 ? 8 : 4);
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
  const void* q;          // [B, H, D]
  const void* k_pages;    // [N, bs, KV, D]
  const void* v_pages;    // [N, bs, KV, D]
  const int* tables;      // [B, NB]
  const int* positions;   // [B]
  void* out;              // [B, H, D]
  int batch, kv_heads, num_blocks, block_size, table_width;
  float scale;
  cudaStream_t stream;
};

// One block per (sequence b = blockIdx.x, KV head k = blockIdx.y).
// D = head dim; G = query heads per KV head. A lane holds EPL = ceil(D/32)
// contiguous elements of a row; for D < 32 the upper lanes hold none.
template <typename T, int D, int G>
__global__ void __launch_bounds__(warps_for(G, D) * 32)
rpa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages, const int* __restrict__ tables,
                  const int* __restrict__ positions, T* __restrict__ out,
                  int kv_heads, int num_blocks, int block_size,
                  int table_width, float scale) {
  constexpr int EPL = D < 32 ? 1 : D / 32;
  constexpr int kWarps = warps_for(G, D);
  constexpr int kThreads = kWarps * 32;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool active = lane * EPL < D;
  const int col = active ? lane * EPL : 0;
  const int heads = kv_heads * G;

  __shared__ float s_max[kWarps][G];
  __shared__ float s_sum[kWarps][G];
  __shared__ float s_acc[kWarps][G][D];

  // slots 0 .. n_valid-1 are visible (slot <= positions[b]); the table
  // covers table_width * block_size slots, and slots past it do not exist
  const int span = table_width * block_size;
  int n_valid = positions[b] + 1;
  if (n_valid > span) n_valid = span;

  float qr[G][EPL];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (active) {
      load_row<T, EPL>(q + (static_cast<int64_t>(b) * heads + kvh * G + r) * D + col,
                       qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[r][e] = 0.f;
    }
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const int* table = tables + static_cast<int64_t>(b) * table_width;
  const int64_t row_stride = static_cast<int64_t>(kv_heads) * D;  // one slot
  const int n_chunks = (n_valid + kChunk - 1) / kChunk;

  for (int c = warp; c < n_chunks; c += kWarps) {
    const int s0 = c * kChunk;
    int64_t row[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int s = s0 + t;
      int phys = 0;
      int off = 0;
      if (s < n_valid) {
        phys = table[s / block_size];
        off = s % block_size;
        // XLA's gather clamps an out-of-range index; do the same rather
        // than read outside the pool
        phys = phys < 0 ? 0 : (phys >= num_blocks ? num_blocks - 1 : phys);
      }
      row[t] = (static_cast<int64_t>(phys) * block_size + off) * row_stride +
               static_cast<int64_t>(kvh) * D + col;
    }

    // scores: issue every K row of the chunk, then reduce
    float kv[kChunk][EPL];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (active && s0 + t < n_valid) {
        load_row<T, EPL>(k_pages + row[t], kv[t]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[t][e] = 0.f;
      }
    }
    float p[G][kChunk];
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        float partial = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) partial += qr[r][e] * kv[t][e];
        const float score = warp_sum(partial) * scale;
        p[r][t] = (s0 + t < n_valid) ? score : -INFINITY;
      }
    }

    // online softmax over the chunk's valid slots (slot s0 is always valid)
    float alpha[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) m_new = fmaxf(m_new, p[r][t]);
      alpha[r] = expf(m[r] - m_new);
      float chunk_sum = 0.f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        p[r][t] = (s0 + t < n_valid) ? expf(p[r][t] - m_new) : 0.f;
        chunk_sum += p[r][t];
      }
      l[r] = l[r] * alpha[r] + chunk_sum;
      m[r] = m_new;
    }

    // weighted values: issue every V row of the chunk, then accumulate
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (active && s0 + t < n_valid) {
        load_row<T, EPL>(v_pages + row[t], kv[t]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[t][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float sum = acc[r][e] * alpha[r];
#pragma unroll
        for (int t = 0; t < kChunk; ++t) sum += p[r][t] * kv[t][e];
        acc[r][e] = sum;
      }
    }
  }

  // merge the warps' states: out = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M)
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (lane == 0) {
      s_max[warp][r] = m[r];
      s_sum[warp][r] = l[r];
    }
    if (active) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) s_acc[warp][r][col + e] = acc[r][e];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float big = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, s_max[w][r]);
    float num = 0.f;
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no slot has m = -inf and weighs exactly zero
      const float weight = s_max[w][r] == -INFINITY ? 0.f : expf(s_max[w][r] - big);
      num += s_acc[w][r][d] * weight;
      den += s_sum[w][r] * weight;
    }
    // n_valid <= 0 cannot come from the engine; write zeros, not NaN
    const float value = den > 0.f ? num / den : 0.f;
    from_float(value, out + (static_cast<int64_t>(b) * heads + kvh * G + r) * D + d);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.batch, a.kv_heads);
  rpa_decode_kernel<T, D, G><<<grid, warps_for(G, D) * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), a.tables, a.positions,
      static_cast<T*>(a.out), a.kv_heads, a.num_blocks, a.block_size,
      a.table_width, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_group(int group, const Args& a) {
  switch (group) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 4: return launch<T, D, 4>(a);
    case 8: return launch<T, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, int group, const Args& a) {
  switch (head_dim) {
    case 16: return dispatch_group<T, 16>(group, a);
    case 32: return dispatch_group<T, 32>(group, a);
    case 64: return dispatch_group<T, 64>(group, a);
    case 128: return dispatch_group<T, 128>(group, a);
    case 256: return dispatch_group<T, 256>(group, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a head_dim / group / dtype with no compiled
// instance (the Python wrapper rejects those before calling).
int rpa_decode(const void* q, const void* k_pages, const void* v_pages,
               const int* page_tables, const int* positions, void* out,
               int batch, int heads, int kv_heads, int head_dim, int num_blocks,
               int block_size, int table_width, int dtype, float scale,
               void* stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || block_size <= 0 ||
      table_width <= 0 || num_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{q, k_pages, v_pages, page_tables, positions, out,
                  batch, kv_heads, num_blocks, block_size, table_width,
                  scale, static_cast<cudaStream_t>(stream)};
  const int group = heads / kv_heads;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_dim<float>(head_dim, group, args);
  } else if (dtype == 1) {
    err = dispatch_dim<__nv_bfloat16>(head_dim, group, args);
  }
  return static_cast<int>(err);
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
