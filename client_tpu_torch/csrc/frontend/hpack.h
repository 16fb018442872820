// HPACK (RFC 7541) header compression for the hand-rolled HTTP/2 client.
//
// An own copy of native/client/hpack.h; the port's gRPC front-end uses it.
//
// TPU-native replacement for the header handling the reference delegates to
// grpc++ (reference: src/c++/library/grpc_client.cc uses grpc::Channel; this
// framework speaks gRPC over its own HTTP/2 stack since the image carries no
// grpc++). Encoder is deliberately simple — static-table references plus
// literal-without-indexing, no Huffman on the way out (gRPC request headers
// are tiny). Decoder is complete: static + dynamic tables, Huffman decode,
// dynamic-table size updates.
#pragma once

#include <cstddef>
#include <cstdint>
#include <deque>
#include <string>
#include <vector>

namespace ctpu {
namespace hpack {

struct Header {
  std::string name;
  std::string value;
};

// Appends the encoded header block for `headers` to `*out`.
void Encode(const std::vector<Header>& headers, std::string* out);

// Decodes a Huffman-coded string (RFC 7541 §5.2). Returns false on a coding
// error (bad padding / EOS in stream).
bool HuffmanDecode(const uint8_t* data, size_t len, std::string* out);

class Decoder {
 public:
  explicit Decoder(size_t max_dynamic_size = 4096)
      : capacity_(max_dynamic_size), protocol_capacity_(max_dynamic_size) {}

  // Decodes one complete header block. Returns false and sets *err on any
  // compression error (connection-fatal per RFC 7540 §4.3).
  bool Decode(const uint8_t* data, size_t len, std::vector<Header>* out,
              std::string* err);

 private:
  bool LookupIndex(uint64_t index, Header* out, std::string* err) const;
  void Insert(Header h);
  void EvictTo(size_t target);

  std::deque<Header> dynamic_;  // front = most recently inserted
  size_t size_ = 0;             // current dynamic table size (RFC accounting)
  size_t capacity_;             // current max size (after size updates)
  size_t protocol_capacity_;    // ceiling from SETTINGS_HEADER_TABLE_SIZE
};

}  // namespace hpack
}  // namespace ctpu
