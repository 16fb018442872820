// K2: multi-query ragged paged attention (the speculative verify) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_rpa_kernel_mq` launched by
// `paged_attention_pallas_mq` in client_tpu/models/paged_attention.py.
//
//   out[b, t, h] = softmax_s(q[b, t, h] . K[s, h / g] * scale) . V[s, h / g]
//
// over the slots s <= positions[b, t]: verify row t sees its own
// speculative prefix and nothing after it. The T*g query rows of a
// (sequence, KV head) are packed and scored together against every K/V row
// the block loads, so a page crosses device memory once for all verify
// rows (the point of a batched verify: T decode launches would read it T
// times). More than kMaxRows (8) packed rows are split over the grid's
// third axis, each slice reading the pages again; the engine's 7B verify
// (T = 5, g = 1) is one slice. The design (split-KV inside one launch, cp.async staging,
// bf16 scores on the tensor cores) and what bounds it are in
// paged_attention_split.cuh.

#include "paged_attention_split.cuh"

namespace {

template <typename T, int D, int R>
__global__ void __launch_bounds__(rpa::kThreads, rpa::kMinBlocks)
rpa_decode_mq_kernel(const rpa::Params p) {
  rpa::split_attention<T, D, R>(p);
}

struct Verify {
  static constexpr bool kRowsFromGroup = false;
  template <typename T, int D, int R>
  static void (*kernel())(rpa::Params) {
    return rpa_decode_mq_kernel<T, D, R>;
  }
};

}  // namespace

extern "C" {

// rows = T, the verify rows of each sequence; every other argument as
// rpa_decode's (paged_attention.cu).
int rpa_decode_mq(const void* q, const void* k_pages, const void* v_pages,
                  const int* page_tables, const int* positions, void* out,
                  int batch, int rows, int heads, int kv_heads, int head_dim,
                  int num_blocks, int block_size, int table_width, int dtype,
                  float scale, void* stream, int partition, float* workspace,
                  long long workspace_floats, unsigned int* counters, int counter_count) {
  if (kv_heads <= 0 || heads % kv_heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  const rpa::Params p{q, k_pages, v_pages, page_tables, positions, out, workspace, counters,
                      batch, rows, heads / kv_heads, kv_heads, num_blocks, block_size,
                      table_width, partition, scale};
  return static_cast<int>(rpa::run<Verify>(dtype, head_dim, p, workspace_floats, counter_count,
                                            static_cast<cudaStream_t>(stream)));
}

// As rpa_describe (paged_attention.cu); K2 has one instance a (dtype,
// head_dim), whatever `rows`.
int rpa_mq_describe(int dtype, int head_dim, int rows, int partition, int* smem_bytes,
                    int* blocks_per_sm) {
  if (partition <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rpa::dispatch<Verify>(
      dtype, head_dim, rows, rpa::Describe{partition, smem_bytes, blocks_per_sm}));
}

const char* rpa_mq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
