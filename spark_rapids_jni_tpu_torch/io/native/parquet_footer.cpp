// Parquet footer parse / filter / rewrite: the port's own copy of the
// reference package's io/native/parquet_footer.cpp, built with g++ at first
// use (ops/_build.py build_host) and bound by io/parquet_footer.py.
//
// Role-equivalent to spark-rapids-jni's NativeParquetJni.cpp (parse the
// thrift footer from host memory, prune row groups to a split's byte range
// by midpoint, prune columns against a case-(in)sensitive schema tree, then
// re-serialize a valid PAR1-framed footer).  The footer is parsed into a
// GENERIC thrift-compact value tree instead of typed structs generated from
// parquet.thrift: unknown/new fields pass through untouched, and the pruner
// edits only the handful of semantically known paths (FileMetaData.schema /
// num_rows / row_groups / column_orders, RowGroup.columns / num_rows).
//
// Exported as a plain C ABI for ctypes (no JNI, no external deps).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// thrift compact protocol: generic value tree
// ---------------------------------------------------------------------------

enum TType : uint8_t {
  T_STOP = 0,
  T_TRUE = 1,
  T_FALSE = 2,
  T_BYTE = 3,
  T_I16 = 4,
  T_I32 = 5,
  T_I64 = 6,
  T_DOUBLE = 7,
  T_BINARY = 8,
  T_LIST = 9,
  T_SET = 10,
  T_MAP = 11,
  T_STRUCT = 12,
};

struct TValue;
using TFields = std::vector<std::pair<int16_t, TValue>>;

struct TValue {
  uint8_t type = T_STOP;
  bool b = false;
  int64_t i = 0;
  double d = 0.0;
  std::string bin;
  uint8_t elem_type = T_STOP;           // for LIST/SET
  std::vector<TValue> elems;            // for LIST/SET
  uint8_t key_type = T_STOP, val_type = T_STOP;  // for MAP
  std::vector<std::pair<TValue, TValue>> kvs;    // for MAP
  std::shared_ptr<TFields> fields;      // for STRUCT (ordered, by field id)

  TValue* field(int16_t id) {
    if (!fields) return nullptr;
    for (auto& [fid, v] : *fields)
      if (fid == id) return &v;
    return nullptr;
  }
  const TValue* field(int16_t id) const {
    return const_cast<TValue*>(this)->field(id);
  }
  int64_t i64_or(int16_t id, int64_t dflt) const {
    auto* f = field(id);
    return f ? f->i : dflt;
  }
  void set_i64(int16_t id, int64_t v, uint8_t ty = T_I64) {
    if (auto* f = field(id)) {
      f->i = v;
      return;
    }
    TValue nv;
    nv.type = ty;
    nv.i = v;
    // keep fields sorted by id so the compact delta encoding stays small
    auto it = fields->begin();
    while (it != fields->end() && it->first < id) ++it;
    fields->insert(it, {id, nv});
  }
};

class Reader {
 public:
  Reader(const uint8_t* p, size_t n) : p_(p), n_(n) {}

  TValue read_struct() {
    TValue out;
    out.type = T_STRUCT;
    out.fields = std::make_shared<TFields>();
    int16_t last_id = 0;
    for (;;) {
      uint8_t head = u8();
      if (head == T_STOP) break;
      uint8_t delta = head >> 4;
      uint8_t type = head & 0x0F;
      int16_t id = delta ? int16_t(last_id + delta) : int16_t(zigzag(varint()));
      last_id = id;
      out.fields->push_back({id, read_value(type)});
    }
    return out;
  }

 private:
  TValue read_value(uint8_t type, bool in_container = false) {
    TValue v;
    v.type = type;
    switch (type) {
      case T_TRUE:
      case T_FALSE:
        if (in_container) {
          // container bools are one byte (1=true, 2=false); field bools
          // live in the field-header type nibble and consume nothing
          v.b = u8() == 1;
          v.type = v.b ? T_TRUE : T_FALSE;
        } else {
          v.b = (type == T_TRUE);
        }
        break;
      case T_BYTE:
        v.i = int8_t(u8());
        break;
      case T_I16:
      case T_I32:
      case T_I64:
        v.i = zigzag(varint());
        break;
      case T_DOUBLE: {
        uint64_t bits = 0;
        for (int k = 0; k < 8; k++) bits |= uint64_t(u8()) << (8 * k);
        std::memcpy(&v.d, &bits, 8);
        break;
      }
      case T_BINARY: {
        uint64_t len = varint();
        need(len);
        v.bin.assign(reinterpret_cast<const char*>(p_ + pos_), len);
        pos_ += len;
        break;
      }
      case T_LIST:
      case T_SET: {
        uint8_t head = u8();
        uint64_t size = head >> 4;
        v.elem_type = head & 0x0F;
        if (size == 15) size = varint();
        // every element consumes >= 1 byte except nothing does 0, so a
        // size beyond the remaining bytes is a corrupt/hostile footer
        if (size > remaining())
          throw std::runtime_error("container size exceeds footer");
        v.elems.reserve(size);
        for (uint64_t k = 0; k < size; k++)
          v.elems.push_back(read_value(v.elem_type, /*in_container=*/true));
        break;
      }
      case T_MAP: {
        uint64_t size = varint();
        if (size > remaining())
          throw std::runtime_error("map size exceeds footer");
        if (size > 0) {
          uint8_t kv = u8();
          v.key_type = kv >> 4;
          v.val_type = kv & 0x0F;
          for (uint64_t k = 0; k < size; k++) {
            TValue key = read_value(v.key_type, /*in_container=*/true);
            TValue val = read_value(v.val_type, /*in_container=*/true);
            v.kvs.push_back({std::move(key), std::move(val)});
          }
        }
        break;
      }
      case T_STRUCT:
        return read_struct();
      default:
        throw std::runtime_error("unknown thrift compact type " +
                                 std::to_string(type));
    }
    return v;
  }

  uint64_t remaining() const { return n_ - pos_; }

  void need(uint64_t n) {
    if (pos_ + n > n_) throw std::runtime_error("footer truncated");
  }
  uint8_t u8() {
    need(1);
    return p_[pos_++];
  }
  uint64_t varint() {
    uint64_t out = 0;
    int shift = 0;
    for (;;) {
      uint8_t b = u8();
      out |= uint64_t(b & 0x7F) << shift;
      if (!(b & 0x80)) return out;
      shift += 7;
      if (shift > 63) throw std::runtime_error("varint overflow");
    }
  }
  static int64_t zigzag(uint64_t v) {
    return int64_t(v >> 1) ^ -int64_t(v & 1);
  }

  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
};

class Writer {
 public:
  void write_struct(const TValue& v) {
    int16_t last_id = 0;
    for (auto& [id, f] : *v.fields) {
      uint8_t type = f.type;
      if (type == T_TRUE || type == T_FALSE)
        type = f.b ? T_TRUE : T_FALSE;
      int delta = id - last_id;
      if (delta > 0 && delta <= 15) {
        u8(uint8_t(delta << 4) | type);
      } else {
        u8(type);
        varint(unzigzag(id));
      }
      write_value(f, /*in_field=*/true);
      last_id = id;
    }
    u8(T_STOP);
  }

  std::string out;

 private:
  void write_value(const TValue& v, bool in_field) {
    switch (v.type) {
      case T_TRUE:
      case T_FALSE:
        if (!in_field) u8(v.b ? 1 : 2);  // container bools: 1=true, 2=false
        break;  // field bools are encoded in the type nibble
      case T_BYTE:
        u8(uint8_t(v.i));
        break;
      case T_I16:
      case T_I32:
      case T_I64:
        varint(unzigzag(v.i));
        break;
      case T_DOUBLE: {
        uint64_t bits;
        double d = v.d;
        std::memcpy(&bits, &d, 8);
        for (int k = 0; k < 8; k++) u8(uint8_t(bits >> (8 * k)));
        break;
      }
      case T_BINARY:
        varint(v.bin.size());
        out.append(v.bin);
        break;
      case T_LIST:
      case T_SET: {
        size_t size = v.elems.size();
        if (size < 15) {
          u8(uint8_t(size << 4) | v.elem_type);
        } else {
          u8(uint8_t(0xF0) | v.elem_type);
          varint(size);
        }
        for (auto& e : v.elems) write_value(e, false);
        break;
      }
      case T_MAP: {
        varint(v.kvs.size());
        if (!v.kvs.empty()) {
          u8(uint8_t(v.key_type << 4) | v.val_type);
          for (auto& [k, val] : v.kvs) {
            write_value(k, false);
            write_value(val, false);
          }
        }
        break;
      }
      case T_STRUCT:
        write_struct(v);
        break;
      default:
        throw std::runtime_error("cannot serialize type " +
                                 std::to_string(v.type));
    }
  }

  void u8(uint8_t b) { out.push_back(char(b)); }
  void varint(uint64_t v) {
    while (v >= 0x80) {
      u8(uint8_t(v) | 0x80);
      v >>= 7;
    }
    u8(uint8_t(v));
  }
  static uint64_t unzigzag(int64_t v) {
    return (uint64_t(v) << 1) ^ uint64_t(v >> 63);
  }
};

// ---------------------------------------------------------------------------
// parquet footer model on top of the generic tree
// ---------------------------------------------------------------------------

// FileMetaData field ids (parquet.thrift)
constexpr int16_t FMD_SCHEMA = 2;
constexpr int16_t FMD_NUM_ROWS = 3;
constexpr int16_t FMD_ROW_GROUPS = 4;
constexpr int16_t FMD_COLUMN_ORDERS = 7;
// SchemaElement
constexpr int16_t SE_TYPE = 1;
constexpr int16_t SE_REPETITION = 3;
constexpr int16_t SE_NAME = 4;
constexpr int16_t SE_NUM_CHILDREN = 5;
constexpr int16_t SE_CONVERTED_TYPE = 6;
// RowGroup
constexpr int16_t RG_COLUMNS = 1;
constexpr int16_t RG_TOTAL_BYTE_SIZE = 2;
constexpr int16_t RG_NUM_ROWS = 3;
constexpr int16_t RG_FILE_OFFSET = 5;
constexpr int16_t RG_TOTAL_COMPRESSED = 6;
// ColumnChunk / ColumnMetaData
constexpr int16_t CC_META = 3;
constexpr int16_t CMD_TOTAL_COMPRESSED = 7;
constexpr int16_t CMD_DATA_PAGE_OFFSET = 9;
constexpr int16_t CMD_DICT_PAGE_OFFSET = 11;
// ConvertedType values
constexpr int64_t CT_MAP = 1;
constexpr int64_t CT_MAP_KEY_VALUE = 2;
constexpr int64_t REP_REPEATED = 2;

enum Tag : int { TAG_VALUE = 0, TAG_STRUCT = 1, TAG_LIST = 2, TAG_MAP = 3 };

std::string ascii_lower(const std::string& s) {
  std::string out = s;
  for (auto& c : out)
    c = char(std::tolower(static_cast<unsigned char>(c)));
  return out;
}

struct PruneNode {
  int tag = TAG_STRUCT;
  std::map<std::string, PruneNode> children;
};

// rebuild the depth-first flattened (names, num_children, tags) request into
// a tree (the same wire format ParquetFooter.java ships)
size_t build_prune_tree(PruneNode& node, const std::vector<std::string>& names,
                        const std::vector<int>& num_children,
                        const std::vector<int>& tags, size_t at, int n_kids,
                        bool ignore_case) {
  for (int k = 0; k < n_kids; k++) {
    std::string nm = ignore_case ? ascii_lower(names.at(at)) : names.at(at);
    PruneNode child;
    child.tag = tags.at(at);
    int kids = num_children.at(at);
    at++;
    at = build_prune_tree(child, names, num_children, tags, at, kids,
                          ignore_case);
    node.children.emplace(std::move(nm), std::move(child));
  }
  return at;
}

struct SchemaWalk {
  const std::vector<TValue>* schema;
  bool ignore_case;
  size_t si = 0;        // current schema element
  size_t chunk = 0;     // current leaf/chunk index
  std::vector<int> keep_schema;        // schema indexes kept
  std::vector<int> new_num_children;   // parallel to keep_schema
  std::vector<int> keep_chunks;        // chunk indexes kept

  const TValue& cur() const { return schema->at(si); }
  bool is_leaf() const { return cur().field(SE_TYPE) != nullptr; }
  int n_children() const { return int(cur().i64_or(SE_NUM_CHILDREN, 0)); }
  std::string name() const {
    auto* f = cur().field(SE_NAME);
    std::string nm = f ? f->bin : "";
    return ignore_case ? ascii_lower(nm) : nm;
  }
  int64_t repetition() const { return cur().i64_or(SE_REPETITION, -1); }

  void skip() {
    int to_skip = 1;
    while (to_skip > 0 && si < schema->size()) {
      if (is_leaf()) chunk++;
      to_skip += n_children();
      to_skip--;
      si++;
    }
  }

  void walk(const PruneNode& node) {
    switch (node.tag) {
      case TAG_STRUCT:
        walk_struct(node);
        break;
      case TAG_VALUE:
        walk_value();
        break;
      case TAG_LIST:
        walk_list(node);
        break;
      case TAG_MAP:
        walk_map(node);
        break;
      default:
        throw std::runtime_error("bad prune tag");
    }
  }

  void walk_value() {
    if (!is_leaf()) throw std::runtime_error("expected a leaf column");
    if (n_children() != 0)
      throw std::runtime_error("leaf with children in schema");
    keep_schema.push_back(int(si));
    new_num_children.push_back(0);
    si++;
    keep_chunks.push_back(int(chunk));
    chunk++;
  }

  void walk_struct(const PruneNode& node) {
    if (is_leaf())
      throw std::runtime_error("expected a struct, found a leaf");
    int kids = n_children();
    keep_schema.push_back(int(si));
    size_t my_count_at = new_num_children.size();
    new_num_children.push_back(0);
    si++;
    for (int k = 0; k < kids && si < schema->size(); k++) {
      auto found = node.children.find(name());
      if (found != node.children.end()) {
        new_num_children[my_count_at]++;
        walk(found->second);
      } else {
        skip();
      }
    }
  }

  void walk_list(const PruneNode& node) {
    // parquet LIST layouts (see format docs LogicalTypes.md):
    //   repeated leaf               -> element is the leaf itself
    //   repeated group, >1 fields   -> the group IS the element
    //   group(LIST) > repeated group(1 field, not legacy names) > element
    //   group(LIST) > repeated element          (older 2-level form)
    auto found = node.children.find("element");
    if (found == node.children.end())
      throw std::runtime_error("LIST request without an 'element' child");
    const TValue& list_item = cur();
    std::string list_name = list_item.field(SE_NAME)
                                ? list_item.field(SE_NAME)->bin
                                : "";
    bool group = !is_leaf();
    if (!group) {
      if (repetition() != REP_REPEATED)
        throw std::runtime_error("expected repeated list item");
      walk_value();
      return;
    }
    if (n_children() > 1) {
      if (repetition() != REP_REPEATED)
        throw std::runtime_error("expected repeated list item");
      walk(found->second);
      return;
    }
    if (n_children() != 1)
      throw std::runtime_error("non-standard outer list group");

    keep_schema.push_back(int(si));
    new_num_children.push_back(1);
    si++;

    if (repetition() != REP_REPEATED)
      throw std::runtime_error("non-repeating list child");
    bool rep_group = !is_leaf();
    int rep_kids = n_children();
    std::string rep_name =
        cur().field(SE_NAME) ? cur().field(SE_NAME)->bin : "";
    if (rep_group && rep_kids == 1 && rep_name != "array" &&
        rep_name != list_name + "_tuple") {
      keep_schema.push_back(int(si));
      new_num_children.push_back(1);
      si++;
      walk(found->second);
    } else {
      walk(found->second);
    }
  }

  void walk_map(const PruneNode& node) {
    auto key_it = node.children.find("key");
    auto val_it = node.children.find("value");
    if (key_it == node.children.end() || val_it == node.children.end())
      throw std::runtime_error("MAP request needs 'key' and 'value'");
    if (is_leaf()) throw std::runtime_error("expected a map group");
    int64_t ct = cur().i64_or(SE_CONVERTED_TYPE, -1);
    if (ct != CT_MAP && ct != CT_MAP_KEY_VALUE)
      throw std::runtime_error("expected a MAP converted type");
    if (n_children() != 1)
      throw std::runtime_error("non-standard outer map group");
    keep_schema.push_back(int(si));
    new_num_children.push_back(1);
    si++;

    if (repetition() != REP_REPEATED)
      throw std::runtime_error("non-repeating map child");
    int rep_kids = n_children();
    if (rep_kids != 1 && rep_kids != 2)
      throw std::runtime_error("map key_value with wrong child count");
    keep_schema.push_back(int(si));
    new_num_children.push_back(rep_kids);
    si++;
    walk(key_it->second);
    if (rep_kids == 2) walk(val_it->second);
  }
};

int64_t chunk_offset(const TValue& column_chunk) {
  const TValue* md = column_chunk.field(CC_META);
  if (!md) return 0;
  int64_t off = md->i64_or(CMD_DATA_PAGE_OFFSET, 0);
  const TValue* dict = md->field(CMD_DICT_PAGE_OFFSET);
  if (dict && off > dict->i) off = dict->i;
  return off;
}

// row-group selection by midpoint, with the PARQUET-2078 bad-file_offset
// fallbacks the java parquet-mr reader applies
std::vector<size_t> select_groups(const std::vector<TValue>& groups,
                                  int64_t part_offset, int64_t part_length) {
  std::vector<size_t> keep;
  bool first_has_md = false;
  if (!groups.empty()) {
    const TValue* cols = groups[0].field(RG_COLUMNS);
    if (cols && !cols->elems.empty())
      first_has_md = cols->elems[0].field(CC_META) != nullptr;
  }
  int64_t pre_start = 0, pre_size = 0;
  for (size_t g = 0; g < groups.size(); g++) {
    const TValue& rg = groups[g];
    const TValue* cols = rg.field(RG_COLUMNS);
    if (!cols || cols->elems.empty()) continue;
    int64_t start;
    if (first_has_md) {
      start = chunk_offset(cols->elems[0]);
    } else {
      start = rg.i64_or(RG_FILE_OFFSET, 0);
      bool invalid = (pre_start == 0 && start != 4) ||
                     (start < pre_start + pre_size);
      if (invalid) start = (pre_start == 0) ? 4 : pre_start + pre_size;
      pre_start = start;
      pre_size = rg.i64_or(RG_TOTAL_COMPRESSED, 0);
    }
    int64_t total = rg.i64_or(RG_TOTAL_COMPRESSED, -1);
    if (total < 0) {
      total = 0;
      for (auto& cc : cols->elems) {
        const TValue* md = cc.field(CC_META);
        if (md) total += md->i64_or(CMD_TOTAL_COMPRESSED, 0);
      }
    }
    int64_t mid = start + total / 2;
    if (mid >= part_offset && mid < part_offset + part_length)
      keep.push_back(g);
  }
  return keep;
}

struct Footer {
  TValue meta;  // FileMetaData struct
  int64_t num_columns = 0;
  std::string error;
};

}  // namespace

extern "C" {

void* pqf_read_and_filter(const uint8_t* buf, long len, long part_offset,
                          long part_length, const char** names,
                          const int* num_children, const int* tags,
                          int n_entries, int parent_num_children,
                          int ignore_case, int do_prune) {
  auto* out = new Footer();
  try {
    Reader r(buf, size_t(len));
    out->meta = r.read_struct();

    TValue* schema = out->meta.field(FMD_SCHEMA);
    TValue* groups = out->meta.field(FMD_ROW_GROUPS);
    if (!schema || schema->elems.empty())
      throw std::runtime_error("footer has no schema");

    // --- row-group pruning by split midpoint -------------------------
    std::vector<TValue> kept_groups;
    if (groups) {
      for (size_t g : select_groups(groups->elems, part_offset, part_length))
        kept_groups.push_back(groups->elems[g]);
      groups->elems = std::move(kept_groups);
    }

    // --- column pruning against the requested schema tree ------------
    if (do_prune) {
      PruneNode root;
      std::vector<std::string> nm(names, names + n_entries);
      std::vector<int> nc(num_children, num_children + n_entries);
      std::vector<int> tg(tags, tags + n_entries);
      build_prune_tree(root, nm, nc, tg, 0, parent_num_children,
                       ignore_case != 0);

      SchemaWalk walk{&schema->elems, ignore_case != 0};
      walk.walk_struct(root);  // the schema root is a struct

      std::vector<TValue> new_schema;
      for (size_t k = 0; k < walk.keep_schema.size(); k++) {
        TValue el = schema->elems[size_t(walk.keep_schema[k])];
        if (el.field(SE_NUM_CHILDREN))
          el.field(SE_NUM_CHILDREN)->i = walk.new_num_children[k];
        else if (walk.new_num_children[k] > 0)
          el.set_i64(SE_NUM_CHILDREN, walk.new_num_children[k], T_I32);
        new_schema.push_back(std::move(el));
      }
      schema->elems = std::move(new_schema);

      if (groups) {
        for (auto& rg : groups->elems) {
          TValue* cols = rg.field(RG_COLUMNS);
          if (!cols) continue;
          std::vector<TValue> kept;
          for (int ci : walk.keep_chunks)
            kept.push_back(cols->elems.at(size_t(ci)));
          cols->elems = std::move(kept);
        }
      }
      // column_orders carries one entry per LEAF column: prune in step
      if (TValue* co = out->meta.field(FMD_COLUMN_ORDERS)) {
        std::vector<TValue> kept;
        for (int ci : walk.keep_chunks)
          if (size_t(ci) < co->elems.size())
            kept.push_back(co->elems[size_t(ci)]);
        co->elems = std::move(kept);
      }
    }

    // --- num_rows reflects the kept row groups -----------------------
    int64_t rows = 0;
    if (groups)
      for (auto& rg : groups->elems) rows += rg.i64_or(RG_NUM_ROWS, 0);
    out->meta.set_i64(FMD_NUM_ROWS, rows, T_I64);

    // top-level column count (root's children after pruning)
    out->num_columns = out->meta.field(FMD_SCHEMA)
                           ->elems[0]
                           .i64_or(SE_NUM_CHILDREN, 0);
    return out;
  } catch (std::exception& e) {
    out->error = e.what();
    return out;
  }
}

const char* pqf_error(void* h) {
  auto* f = static_cast<Footer*>(h);
  return f->error.empty() ? nullptr : f->error.c_str();
}

void pqf_free(void* h) { delete static_cast<Footer*>(h); }

long pqf_num_rows(void* h) {
  auto* f = static_cast<Footer*>(h);
  auto* v = f->meta.field(FMD_NUM_ROWS);
  return v ? long(v->i) : 0;
}

long pqf_num_columns(void* h) {
  return long(static_cast<Footer*>(h)->num_columns);
}

long pqf_num_row_groups(void* h) {
  auto* f = static_cast<Footer*>(h);
  auto* g = f->meta.field(FMD_ROW_GROUPS);
  return g ? long(g->elems.size()) : 0;
}

// Serialized "footer file": PAR1 + thrift + u32 length + PAR1 (the same
// framing the reference's serializeThriftFile emits for the cudf reader).
long pqf_serialize(void* h, uint8_t* outbuf, long cap) {
  auto* f = static_cast<Footer*>(h);
  Writer w;
  w.write_struct(f->meta);
  uint32_t tlen = uint32_t(w.out.size());
  long total = 4 + long(tlen) + 4 + 4;
  if (outbuf == nullptr) return total;
  if (cap < total) return -1;
  std::memcpy(outbuf, "PAR1", 4);
  std::memcpy(outbuf + 4, w.out.data(), tlen);
  std::memcpy(outbuf + 4 + tlen, &tlen, 4);
  std::memcpy(outbuf + 8 + tlen, "PAR1", 4);
  return total;
}

}  // extern "C"
