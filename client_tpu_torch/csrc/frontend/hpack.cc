// An own copy of native/client/hpack.cc.
#include "hpack.h"

#include <memory>

#include "hpack_tables.h"

namespace ctpu {
namespace hpack {

namespace {

constexpr size_t kStaticCount = 61;
// Per-entry overhead in the dynamic-table size accounting (RFC 7541 §4.1).
constexpr size_t kEntryOverhead = 32;

// ---- Integer coding (RFC 7541 §5.1) ----

void EncodeInt(uint8_t prefix_bits, uint8_t flags, uint64_t value,
               std::string* out) {
  const uint64_t max_prefix = (1u << prefix_bits) - 1;
  if (value < max_prefix) {
    out->push_back(static_cast<char>(flags | value));
    return;
  }
  out->push_back(static_cast<char>(flags | max_prefix));
  value -= max_prefix;
  while (value >= 128) {
    out->push_back(static_cast<char>((value & 0x7f) | 0x80));
    value >>= 7;
  }
  out->push_back(static_cast<char>(value));
}

bool DecodeInt(const uint8_t* data, size_t len, size_t* pos,
               uint8_t prefix_bits, uint64_t* value) {
  if (*pos >= len) return false;
  const uint64_t max_prefix = (1u << prefix_bits) - 1;
  uint64_t v = data[(*pos)++] & max_prefix;
  if (v < max_prefix) {
    *value = v;
    return true;
  }
  uint64_t shift = 0;
  while (true) {
    if (*pos >= len || shift > 56) return false;
    uint8_t b = data[(*pos)++];
    v += static_cast<uint64_t>(b & 0x7f) << shift;
    shift += 7;
    if (!(b & 0x80)) break;
  }
  *value = v;
  return true;
}

// ---- Huffman decode tree, built once from the RFC table ----

struct HuffNode {
  int16_t child[2] = {-1, -1};
  int16_t symbol = -1;  // 0..255 leaf, 256 = EOS
};

struct HuffTree {
  std::vector<HuffNode> nodes;
  HuffTree() {
    nodes.emplace_back();
    for (int sym = 0; sym <= 256; ++sym) {
      uint32_t code = kHuffmanCodes[sym];
      uint8_t bits = kHuffmanLengths[sym];
      int cur = 0;
      for (int i = bits - 1; i >= 0; --i) {
        int bit = (code >> i) & 1;
        if (nodes[cur].child[bit] < 0) {
          nodes[cur].child[bit] = static_cast<int16_t>(nodes.size());
          nodes.emplace_back();
        }
        cur = nodes[cur].child[bit];
      }
      nodes[cur].symbol = static_cast<int16_t>(sym);
    }
  }
};

const HuffTree& Tree() {
  static const HuffTree* tree = new HuffTree();
  return *tree;
}

// ---- String literal coding (RFC 7541 §5.2) ----

bool DecodeString(const uint8_t* data, size_t len, size_t* pos,
                  std::string* out) {
  if (*pos >= len) return false;
  const bool huffman = (data[*pos] & 0x80) != 0;
  uint64_t slen;
  if (!DecodeInt(data, len, pos, 7, &slen)) return false;
  if (*pos + slen > len) return false;
  if (huffman) {
    if (!HuffmanDecode(data + *pos, slen, out)) return false;
  } else {
    out->assign(reinterpret_cast<const char*>(data + *pos), slen);
  }
  *pos += slen;
  return true;
}

void EncodeString(const std::string& s, std::string* out) {
  EncodeInt(7, 0x00, s.size(), out);  // plain, no Huffman
  out->append(s);
}

}  // namespace

bool HuffmanDecode(const uint8_t* data, size_t len, std::string* out) {
  const HuffTree& tree = Tree();
  int cur = 0;
  int bits_since_symbol = 0;
  bool all_ones = true;  // padding must be the EOS-prefix, i.e. all 1s
  for (size_t i = 0; i < len; ++i) {
    for (int b = 7; b >= 0; --b) {
      int bit = (data[i] >> b) & 1;
      if (!bit) all_ones = false;
      cur = tree.nodes[cur].child[bit];
      if (cur < 0) return false;
      ++bits_since_symbol;
      int16_t sym = tree.nodes[cur].symbol;
      if (sym >= 0) {
        if (sym == 256) return false;  // EOS inside stream is an error
        out->push_back(static_cast<char>(sym));
        cur = 0;
        bits_since_symbol = 0;
        all_ones = true;
      }
    }
  }
  // Trailing partial code: must be ≤7 bits of all-1 padding.
  return bits_since_symbol <= 7 && all_ones;
}

void Encode(const std::vector<Header>& headers, std::string* out) {
  for (const auto& h : headers) {
    // Full static-table match → indexed field (RFC 7541 §6.1).
    int name_index = 0;
    for (size_t i = 0; i < kStaticCount; ++i) {
      if (h.name == kStaticTable[i].name) {
        if (name_index == 0) name_index = static_cast<int>(i + 1);
        if (h.value == kStaticTable[i].value) {
          name_index = static_cast<int>(i + 1);
          EncodeInt(7, 0x80, name_index, out);
          name_index = -1;
          break;
        }
      }
    }
    if (name_index < 0) continue;  // emitted as fully indexed
    // Literal without indexing (§6.2.2): 4-bit name index or literal name.
    if (name_index > 0) {
      EncodeInt(4, 0x00, name_index, out);
    } else {
      out->push_back(0x00);
      EncodeString(h.name, out);
    }
    EncodeString(h.value, out);
  }
}

bool Decoder::LookupIndex(uint64_t index, Header* out, std::string* err) const {
  if (index == 0) {
    *err = "hpack: index 0";
    return false;
  }
  if (index <= kStaticCount) {
    out->name = kStaticTable[index - 1].name;
    out->value = kStaticTable[index - 1].value;
    return true;
  }
  const size_t di = index - kStaticCount - 1;
  if (di >= dynamic_.size()) {
    *err = "hpack: index out of range";
    return false;
  }
  *out = dynamic_[di];
  return true;
}

void Decoder::EvictTo(size_t target) {
  while (size_ > target && !dynamic_.empty()) {
    const Header& h = dynamic_.back();
    size_ -= h.name.size() + h.value.size() + kEntryOverhead;
    dynamic_.pop_back();
  }
}

void Decoder::Insert(Header h) {
  const size_t entry = h.name.size() + h.value.size() + kEntryOverhead;
  if (entry > capacity_) {  // clears the whole table (RFC 7541 §4.4)
    EvictTo(0);
    return;
  }
  EvictTo(capacity_ - entry);
  size_ += entry;
  dynamic_.push_front(std::move(h));
}

bool Decoder::Decode(const uint8_t* data, size_t len, std::vector<Header>* out,
                     std::string* err) {
  size_t pos = 0;
  while (pos < len) {
    const uint8_t b = data[pos];
    if (b & 0x80) {  // indexed header field
      uint64_t index;
      if (!DecodeInt(data, len, &pos, 7, &index)) {
        *err = "hpack: bad indexed field";
        return false;
      }
      Header h;
      if (!LookupIndex(index, &h, err)) return false;
      out->push_back(std::move(h));
    } else if (b & 0x40) {  // literal with incremental indexing
      uint64_t index;
      if (!DecodeInt(data, len, &pos, 6, &index)) {
        *err = "hpack: bad literal";
        return false;
      }
      Header h;
      if (index > 0) {
        Header nh;
        if (!LookupIndex(index, &nh, err)) return false;
        h.name = std::move(nh.name);
      } else if (!DecodeString(data, len, &pos, &h.name)) {
        *err = "hpack: bad name string";
        return false;
      }
      if (!DecodeString(data, len, &pos, &h.value)) {
        *err = "hpack: bad value string";
        return false;
      }
      out->push_back(h);
      Insert(std::move(h));
    } else if (b & 0x20) {  // dynamic table size update
      uint64_t sz;
      if (!DecodeInt(data, len, &pos, 5, &sz)) {
        *err = "hpack: bad size update";
        return false;
      }
      if (sz > protocol_capacity_) {
        *err = "hpack: size update above SETTINGS cap";
        return false;
      }
      capacity_ = sz;
      EvictTo(capacity_);
    } else {  // literal without indexing / never indexed (0x00 / 0x10)
      uint64_t index;
      if (!DecodeInt(data, len, &pos, 4, &index)) {
        *err = "hpack: bad literal";
        return false;
      }
      Header h;
      if (index > 0) {
        Header nh;
        if (!LookupIndex(index, &nh, err)) return false;
        h.name = std::move(nh.name);
      } else if (!DecodeString(data, len, &pos, &h.name)) {
        *err = "hpack: bad name string";
        return false;
      }
      if (!DecodeString(data, len, &pos, &h.value)) {
        *err = "hpack: bad value string";
        return false;
      }
      out->push_back(std::move(h));
    }
  }
  return true;
}

}  // namespace hpack
}  // namespace ctpu
