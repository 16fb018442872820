// K1: ragged paged-attention decode for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_rpa_kernel` launched by
// `paged_attention_pallas` in client_tpu/models/paged_attention.py.
//
//   out[b, h] = softmax_s(q[b, h] . K[s, h / g] * scale) . V[s, h / g]
//
// over the slots s <= positions[b]. This is the multi-query verify with
// T = 1: q [B, H, D] and positions [B] have the layouts of [B, 1, H, D] and
// [B, 1], and the g query heads of a KV head are the packed rows that share
// every K/V row the block loads. The design (split-KV inside one launch,
// cp.async staging, bf16 scores on the tensor cores) and what bounds it are
// in paged_attention_split.cuh.

#include "paged_attention_split.cuh"

namespace {

template <typename T, int D, int R>
__global__ void __launch_bounds__(rpa::kThreads, rpa::kMinBlocks)
rpa_decode_kernel(const rpa::Params p) {
  rpa::split_attention<T, D, R>(p);
}

struct Decode {
  static constexpr bool kRowsFromGroup = true;
  template <typename T, int D, int R>
  static void (*kernel())(rpa::Params) {
    return rpa_decode_kernel<T, D, R>;
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. partition: slots one block walks (P).
// workspace (workspace_floats floats) and counters (counter_count, zero
// between launches) are the caller's scratch for contexts split over more
// than one partition; both may be null when the table spans one partition.
// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a shape,
// dtype or scratch the kernel does not take.
int rpa_decode(const void* q, const void* k_pages, const void* v_pages,
               const int* page_tables, const int* positions, void* out,
               int batch, int heads, int kv_heads, int head_dim, int num_blocks,
               int block_size, int table_width, int dtype, float scale,
               void* stream, int partition, float* workspace,
               long long workspace_floats, unsigned int* counters, int counter_count) {
  if (kv_heads <= 0 || heads % kv_heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  const rpa::Params p{q, k_pages, v_pages, page_tables, positions, out, workspace, counters,
                      batch, 1, heads / kv_heads, kv_heads, num_blocks, block_size,
                      table_width, partition, scale};
  return static_cast<int>(rpa::run<Decode>(dtype, head_dim, p, workspace_floats, counter_count,
                                            static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of the (dtype, head_dim, group) instance at
// `partition`, and how many of its blocks an SM holds.
int rpa_describe(int dtype, int head_dim, int group, int partition, int* smem_bytes,
                 int* blocks_per_sm) {
  if (partition <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rpa::dispatch<Decode>(
      dtype, head_dim, group, rpa::Describe{partition, smem_bytes, blocks_per_sm}));
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
