// Native Avro -> columnar ingest core (the PyTorch port's own copy of
// photon_ml_tpu/native/avro_reader.cpp, built by
// photon_ml_tpu_torch/io/native.py).
//
// The reference parses Avro on JVM executors (avro/AvroIOUtils.scala:46-139,
// avro/data/DataProcessingUtils.scala:34-131); feeding an accelerator from a
// single host makes ingest throughput the bottleneck instead (SURVEY §7
// hard-part 6), and the pure-Python codec in io/avro.py decodes ~10^5
// records/s. This translation unit is the native replacement for the hot
// READ path: container-file framing + deflate, a schema "op program"
// interpreter (the Python side compiles the schema JSON into flat opcodes,
// so C++ never parses JSON), and the vocabulary join (feature (name, term)
// -> column id) done with a native hash map so Python touches no per-record
// values at all. Output is columnar: scalar field arrays, COO feature
// triplets per vocabulary, and entity-string pools.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image). All memory is
// owned by a Reader handle; numpy copies out and frees it.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <memory>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <zlib.h>

// libdeflate inflates ~2-3x faster than zlib; the Python builder tries
// -DPML_USE_LIBDEFLATE -ldeflate first and falls back to plain zlib.
#ifdef PML_USE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// schema op program (must mirror photon_ml_tpu_torch/io/native.py)
// ---------------------------------------------------------------------------
// Each record field compiles to one op. Optional fields (union [null, X])
// set the OPTIONAL bit; the decoder then reads the union branch index first.
enum Op : int32_t {
  OP_SCALAR_COL = 1,   // double/float/int/long/boolean -> f64 column `arg`
  OP_UID = 2,          // string -> uid string pool
  OP_FEATURES = 3,     // array<record{name,term,value,...}> -> COO triplets
  OP_METADATA = 4,     // map<string> -> entity columns for requested keys
  OP_SKIP = 5,         // any field we don't consume
};
constexpr int32_t OPTIONAL_BIT = 1 << 8;
// When set, the union's null branch is index 1 ([X, null]) instead of 0.
constexpr int32_t NULL_SECOND_BIT = 1 << 9;

// Wire type of the underlying value, for both scalar decode and skipping.
enum Wire : int32_t {
  W_NULL = 0,
  W_BOOLEAN = 1,
  W_INT = 2,
  W_LONG = 3,
  W_FLOAT = 4,
  W_DOUBLE = 5,
  W_STRING = 6,
  W_BYTES = 7,
  W_FEATURE_ARRAY = 8,  // array of feature records
  W_STRING_MAP = 9,     // map<string>
};

// One compiled field: op | OPTIONAL_BIT?, wire, arg (column index), and for
// OP_FEATURES the wire codes of the feature-record's own fields follow via
// the shared feature descriptor (name/term/value positions + extra skips).
struct FieldProg {
  int32_t op;
  int32_t wire;
  int32_t arg;
};

struct Slice {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool fail = false;

  bool need(size_t k) {
    if (off + k > n) {
      fail = true;
      return false;
    }
    return true;
  }
};

int64_t read_long(Slice& s) {
  uint64_t acc = 0;
  int shift = 0;
  while (true) {
    if (!s.need(1)) return 0;
    uint8_t b = s.p[s.off++];
    acc |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 63) {
      s.fail = true;
      return 0;
    }
  }
  return static_cast<int64_t>(acc >> 1) ^ -static_cast<int64_t>(acc & 1);
}

double read_double(Slice& s) {
  if (!s.need(8)) return 0.0;
  double v;
  std::memcpy(&v, s.p + s.off, 8);
  s.off += 8;
  return v;
}

float read_float(Slice& s) {
  if (!s.need(4)) return 0.0f;
  float v;
  std::memcpy(&v, s.p + s.off, 4);
  s.off += 4;
  return v;
}

std::string_view read_string(Slice& s) {
  int64_t len = read_long(s);
  if (len < 0 || !s.need(static_cast<size_t>(len))) {
    s.fail = true;
    return {};
  }
  std::string_view v(reinterpret_cast<const char*>(s.p + s.off),
                     static_cast<size_t>(len));
  s.off += static_cast<size_t>(len);
  return v;
}

void skip_wire(Slice& s, int32_t wire);

void skip_blocks(Slice& s, const std::vector<int32_t>& item_wires) {
  // arrays and maps share the block framing: count (negative => byte size
  // follows, skippable wholesale), items, terminated by count 0.
  while (!s.fail) {
    int64_t count = read_long(s);
    if (count == 0) break;
    if (count < 0) {
      int64_t nbytes = read_long(s);
      if (nbytes < 0 || !s.need(static_cast<size_t>(nbytes))) {
        s.fail = true;
        return;
      }
      s.off += static_cast<size_t>(nbytes);
      continue;
    }
    for (int64_t i = 0; i < count && !s.fail; ++i)
      for (int32_t w : item_wires) skip_wire(s, w);
  }
}

void skip_wire(Slice& s, int32_t wire) {
  switch (wire) {
    case W_NULL:
      break;
    case W_BOOLEAN:
      if (s.need(1)) s.off += 1;
      break;
    case W_INT:
    case W_LONG:
      read_long(s);
      break;
    case W_FLOAT:
      if (s.need(4)) s.off += 4;
      break;
    case W_DOUBLE:
      if (s.need(8)) s.off += 8;
      break;
    case W_STRING:
    case W_BYTES:
      read_string(s);
      break;
    case W_STRING_MAP: {
      std::vector<int32_t> kv = {W_STRING, W_STRING};
      skip_blocks(s, kv);
      break;
    }
    default:
      s.fail = true;
  }
}

double read_scalar(Slice& s, int32_t wire) {
  switch (wire) {
    case W_BOOLEAN:
      return s.need(1) ? static_cast<double>(s.p[s.off++] != 0) : 0.0;
    case W_INT:
    case W_LONG:
      return static_cast<double>(read_long(s));
    case W_FLOAT:
      return static_cast<double>(read_float(s));
    case W_DOUBLE:
      return read_double(s);
    default:
      s.fail = true;
      return 0.0;
  }
}

// ---------------------------------------------------------------------------
// vocabulary
// ---------------------------------------------------------------------------

// FNV-1a, spread over the (name, '\x01', term) spans so lookups never
// materialize the concatenated key (the decode hot path's former top cost).
constexpr uint64_t kFnvSeed = 0xcbf29ce484222325ull;

inline uint64_t fnv1a(uint64_t h, const char* p, size_t n) {
  for (size_t i = 0; i < n; ++i)
    h = (h ^ static_cast<uint8_t>(p[i])) * 0x100000001b3ull;
  return h;
}

struct Vocab {
  // open-addressing flat table over the key blob: entries are
  // (hash, blob offset, byte length, column id); linear probing, ~50%
  // load. Replaces std::unordered_map<string_view,...> — no per-feature
  // key concatenation, no node indirection, hash compared before memcmp.
  struct Entry {
    uint64_t hash;
    int64_t off;
    int32_t len;   // -1 = empty slot
    int32_t value;
  };
  std::string storage;
  std::vector<Entry> table;
  uint64_t mask = 0;
  int32_t intercept = -1;  // intercept column: injected by Python, not here

  void build(int32_t count, const int64_t* lo_offsets, int64_t base) {
    size_t cap = 16;
    while (cap < static_cast<size_t>(count) * 2) cap <<= 1;
    table.assign(cap, Entry{0, 0, -1, 0});
    mask = cap - 1;
    for (int32_t i = 0; i < count; ++i) {
      int64_t a = lo_offsets[i] - base;
      int64_t b = lo_offsets[i + 1] - base;
      uint64_t h = fnv1a(kFnvSeed, storage.data() + a,
                         static_cast<size_t>(b - a));
      size_t slot = static_cast<size_t>(h) & mask;
      while (table[slot].len >= 0) slot = (slot + 1) & mask;
      table[slot] = Entry{h, a, static_cast<int32_t>(b - a), i};
    }
  }

  // find by (name, term) without concatenating: hash and compare the two
  // spans against the stored key bytes (name + '\x01' + term).
  int32_t find(std::string_view name, std::string_view term) const {
    if (table.empty()) return -1;
    uint64_t h = fnv1a(kFnvSeed, name.data(), name.size());
    const char sep = '\x01';
    h = fnv1a(h, &sep, 1);
    h = fnv1a(h, term.data(), term.size());
    int32_t want = static_cast<int32_t>(name.size() + 1 + term.size());
    size_t slot = static_cast<size_t>(h) & mask;
    while (true) {
      const Entry& e = table[slot];
      if (e.len < 0) return -1;
      if (e.hash == h && e.len == want) {
        const char* k = storage.data() + e.off;
        if (std::memcmp(k, name.data(), name.size()) == 0 &&
            k[name.size()] == sep &&
            std::memcmp(k + name.size() + 1, term.data(), term.size()) == 0)
          return e.value;
      }
      slot = (slot + 1) & mask;
    }
  }
};

// Immutable after construction; shared READ-ONLY by every reader (one
// build per ingest, not per file/thread).
struct VocabSet {
  std::vector<Vocab> vocabs;
};

// ---------------------------------------------------------------------------
// reader state
// ---------------------------------------------------------------------------

struct StringPool {
  std::string bytes;
  std::vector<int64_t> offsets{0};  // n+1 offsets

  void push(std::string_view v) {
    bytes.append(v.data(), v.size());
    offsets.push_back(static_cast<int64_t>(bytes.size()));
  }
  void push_empty() { offsets.push_back(static_cast<int64_t>(bytes.size())); }
};

struct Reader {
  std::string error;

  std::vector<FieldProg> prog;
  // feature-record layout: wires of its fields in order; positions of
  // name/term/value within them (-1 when absent, e.g. no term).
  std::vector<int32_t> feat_wires;
  std::vector<uint8_t> feat_optional;
  int32_t feat_name = -1, feat_term = -1, feat_value = -1;

  const VocabSet* vocabset = nullptr;  // non-owning, shared, read-only
  std::vector<std::string> entity_keys;

  int64_t nrecords = 0;
  int64_t nscalars = 0;
  std::vector<std::vector<double>> scalar_cols;   // [col][record]
  std::vector<std::vector<uint8_t>> scalar_seen;  // optional present flags
  StringPool uids;
  std::vector<StringPool> entities;  // per entity key

  // per-vocab COO triplets
  std::vector<std::vector<int32_t>> coo_rows;
  std::vector<std::vector<int32_t>> coo_cols;
  std::vector<std::vector<double>> coo_vals;

  // vocabulary-building mode (FeatureIndexingJob / DefaultIndexMap analog,
  // util/DefaultIndexMap.scala:23): collect distinct feature keys natively.
  bool collect_keys = false;
  std::unordered_set<std::string> keyset;

  std::string scratch_key;
  std::vector<uint8_t> inflate_buf;
  std::vector<std::string_view> meta_found;
  std::vector<uint8_t> meta_hit;
};

#ifdef PML_USE_LIBDEFLATE
bool inflate_raw(const uint8_t* src, size_t srclen, std::vector<uint8_t>& out) {
  // Avro deflate codec = raw deflate stream; libdeflate wants the output
  // size up front, so guess and grow (container blocks are ~64KB-4MB)
  thread_local std::unique_ptr<libdeflate_decompressor,
                               void (*)(libdeflate_decompressor*)>
      dec(libdeflate_alloc_decompressor(), libdeflate_free_decompressor);
  if (!dec) return false;
  size_t cap = std::max<size_t>(srclen * 4, 1 << 16);
  while (true) {
    out.resize(cap);
    size_t actual = 0;
    libdeflate_result rc = libdeflate_deflate_decompress(
        dec.get(), src, srclen, out.data(), cap, &actual);
    if (rc == LIBDEFLATE_SUCCESS) {
      out.resize(actual);
      return true;
    }
    if (rc != LIBDEFLATE_INSUFFICIENT_SPACE || cap > (size_t{1} << 34))
      return false;
    cap *= 2;
  }
}
#else
bool inflate_raw(const uint8_t* src, size_t srclen, std::vector<uint8_t>& out) {
  // Avro deflate codec = raw deflate stream (no zlib header, no checksum)
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  out.clear();
  out.resize(std::max<size_t>(srclen * 4, 1 << 16));
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(srclen);
  size_t written = 0;
  int rc = Z_OK;
  while (rc != Z_STREAM_END) {
    if (written == out.size()) out.resize(out.size() * 2);
    zs.next_out = out.data() + written;
    zs.avail_out = static_cast<uInt>(out.size() - written);
    rc = inflate(&zs, Z_NO_FLUSH);
    written = out.size() - zs.avail_out;
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    if (rc == Z_OK && zs.avail_in == 0 && zs.avail_out != 0) break;
  }
  inflateEnd(&zs);
  out.resize(written);
  return true;
}
#endif

bool decode_record(Reader& r, Slice& s) {
  int64_t row = r.nrecords;
  for (const FieldProg& f : r.prog) {
    int32_t op = f.op & 0xFF;
    int32_t wire = f.wire;
    if (f.op & OPTIONAL_BIT) {
      int64_t branch = read_long(s);
      if (s.fail) return false;
      int64_t null_branch = (f.op & NULL_SECOND_BIT) ? 1 : 0;
      if (branch == null_branch) {
        if (op == OP_SCALAR_COL) r.scalar_seen[f.arg].push_back(0);
        if (op == OP_UID) r.uids.push_empty();
        if (op == OP_METADATA)
          for (auto& pool : r.entities) pool.push_empty();
        continue;
      }
    }
    switch (op) {
      case OP_SCALAR_COL: {
        double v = read_scalar(s, wire);
        r.scalar_cols[f.arg].push_back(v);
        r.scalar_seen[f.arg].push_back(1);
        break;
      }
      case OP_UID:
        r.uids.push(read_string(s));
        break;
      case OP_SKIP:
        skip_wire(s, wire);
        break;
      case OP_FEATURES: {
        while (!s.fail) {
          int64_t count = read_long(s);
          if (count == 0) break;
          if (count < 0) {
            read_long(s);  // byte size, unused: we decode items anyway
            count = -count;
          }
          for (int64_t i = 0; i < count && !s.fail; ++i) {
            std::string_view name, term;
            double value = 0.0;
            bool has_value = false;
            for (size_t fi = 0; fi < r.feat_wires.size(); ++fi) {
              int32_t fw = r.feat_wires[fi];
              if (r.feat_optional[fi]) {
                int64_t branch = read_long(s);
                if (branch == 0) continue;
              }
              if (static_cast<int32_t>(fi) == r.feat_name)
                name = read_string(s);
              else if (static_cast<int32_t>(fi) == r.feat_term)
                term = read_string(s);
              else if (static_cast<int32_t>(fi) == r.feat_value) {
                value = read_scalar(s, fw);
                has_value = true;
              } else
                skip_wire(s, fw);
            }
            if (s.fail || !has_value) continue;
            if (r.collect_keys) {
              // key = name + "\x01" + term (io/vocab.feature_key); only
              // the vocabulary-building pass materializes it
              r.scratch_key.assign(name.data(), name.size());
              r.scratch_key.push_back('\x01');
              r.scratch_key.append(term.data(), term.size());
              r.keyset.insert(r.scratch_key);
            }
            const auto& vocabs = r.vocabset->vocabs;
            for (size_t vi = 0; vi < vocabs.size(); ++vi) {
              int32_t col = vocabs[vi].find(name, term);
              if (col < 0 || col == vocabs[vi].intercept) continue;
              r.coo_rows[vi].push_back(static_cast<int32_t>(row));
              r.coo_cols[vi].push_back(col);
              r.coo_vals[vi].push_back(value);
            }
          }
        }
        break;
      }
      case OP_METADATA: {
        // map<string>: route requested keys into entity pools, in one pass.
        auto& found = r.meta_found;
        auto& hit = r.meta_hit;
        found.assign(r.entity_keys.size(), {});
        hit.assign(r.entity_keys.size(), 0);
        while (!s.fail) {
          int64_t count = read_long(s);
          if (count == 0) break;
          if (count < 0) {
            read_long(s);
            count = -count;
          }
          for (int64_t i = 0; i < count && !s.fail; ++i) {
            std::string_view k = read_string(s);
            std::string_view v = read_string(s);
            for (size_t ei = 0; ei < r.entity_keys.size(); ++ei)
              if (k == r.entity_keys[ei]) {
                found[ei] = v;
                hit[ei] = 1;
              }
          }
        }
        for (size_t ei = 0; ei < r.entity_keys.size(); ++ei) {
          if (hit[ei])
            r.entities[ei].push(found[ei]);
          else
            r.entities[ei].push_empty();
        }
        break;
      }
      default:
        r.error = "bad op in field program";
        return false;
    }
    if (s.fail) return false;
  }
  // optional scalar columns: default-fill rows where the field was null
  for (int32_t c = 0; c < r.nscalars; ++c)
    if (static_cast<int64_t>(r.scalar_cols[c].size()) <= row)
      r.scalar_cols[c].push_back(0.0);
  r.nrecords += 1;
  return true;
}

}  // namespace

extern "C" {

// Build an immutable vocabulary set. Keys arrive as one concatenated byte
// blob with an explicit cumulative offset table (total_keys + 1 entries
// spanning every vocab, in order) — offsets, not separators, so keys may
// contain ANY byte ('\x01' separates name/term inside a key; names can
// embed newlines). Shared read-only by any number of readers/threads;
// freed by the caller AFTER every reader using it.
void* pml_vocabset_new(const char* vocab_blob, const int64_t* key_offsets,
                       const int32_t* vocab_counts,
                       const int32_t* vocab_intercepts, int32_t nvocabs) {
  VocabSet* vs = new VocabSet();
  // build each Vocab in place: the map's string_views point into
  // v.storage, so the string must never move after the views are taken
  // (short storage is SSO-inline and does NOT survive a move).
  vs->vocabs.reserve(static_cast<size_t>(nvocabs));
  int64_t key_base = 0;  // index into the global offset table
  for (int32_t vi = 0; vi < nvocabs; ++vi) {
    vs->vocabs.emplace_back();
    Vocab& v = vs->vocabs.back();
    int32_t count = vocab_counts[vi];
    int64_t lo = key_offsets[key_base];
    int64_t hi = key_offsets[key_base + count];
    v.storage.assign(vocab_blob + lo, static_cast<size_t>(hi - lo));
    v.intercept = vocab_intercepts[vi];
    v.build(count, key_offsets + key_base, lo);
    key_base += count;
  }
  return vs;
}

void pml_vocabset_free(void* handle) {
  delete static_cast<VocabSet*>(handle);
}

// Create a reader bound to a (shared) vocabulary set. field_prog: flat
// int32 triples (op, wire, arg). feat_desc: [nfields, name_pos, term_pos,
// value_pos, wire0, opt0, wire1, opt1, ...]. entity_blob/entity_offsets
// carry the requested metadataMap keys offset-framed like vocab keys.
void* pml_reader_new(const int32_t* field_prog, int32_t nfields,
                     const int32_t* feat_desc, void* vocabset,
                     const char* entity_blob, const int64_t* entity_offsets,
                     int32_t nentities, int32_t collect_keys) {
  Reader* r = new Reader();
  r->collect_keys = collect_keys != 0;
  r->vocabset = static_cast<const VocabSet*>(vocabset);
  int32_t nvocabs = static_cast<int32_t>(r->vocabset->vocabs.size());
  // the Python contract reserves columns 0..2 (label/offset/weight) even
  // when the schema lacks some of those fields; absent columns read as
  // all-default with seen=0.
  int64_t nscalars = 3;
  for (int32_t i = 0; i < nfields; ++i) {
    FieldProg f{field_prog[3 * i], field_prog[3 * i + 1],
                field_prog[3 * i + 2]};
    r->prog.push_back(f);
    if ((f.op & 0xFF) == OP_SCALAR_COL && f.arg >= nscalars)
      nscalars = f.arg + 1;
  }
  r->nscalars = nscalars;
  r->scalar_cols.resize(nscalars);
  r->scalar_seen.resize(nscalars);

  int32_t nf = feat_desc[0];
  r->feat_name = feat_desc[1];
  r->feat_term = feat_desc[2];
  r->feat_value = feat_desc[3];
  for (int32_t i = 0; i < nf; ++i) {
    r->feat_wires.push_back(feat_desc[4 + 2 * i]);
    r->feat_optional.push_back(static_cast<uint8_t>(feat_desc[5 + 2 * i]));
  }

  r->coo_rows.resize(nvocabs);
  r->coo_cols.resize(nvocabs);
  r->coo_vals.resize(nvocabs);

  for (int32_t i = 0; i < nentities; ++i)
    r->entity_keys.emplace_back(
        entity_blob + entity_offsets[i],
        static_cast<size_t>(entity_offsets[i + 1] - entity_offsets[i]));
  r->entities.resize(r->entity_keys.size());
  return r;
}

// Feed one container-file BLOCK (already framed by Python: count + payload).
// codec: 0 = null, 1 = deflate. Returns records decoded, or -1 on error.
int64_t pml_reader_feed(void* handle, const uint8_t* data, int64_t len,
                        int64_t count, int32_t codec) {
  Reader* r = static_cast<Reader*>(handle);
  const uint8_t* payload = data;
  size_t payload_len = static_cast<size_t>(len);
  if (codec == 1) {
    if (!inflate_raw(data, static_cast<size_t>(len), r->inflate_buf)) {
      r->error = "deflate decompression failed";
      return -1;
    }
    payload = r->inflate_buf.data();
    payload_len = r->inflate_buf.size();
  }
  Slice s{payload, payload_len};
  for (int64_t i = 0; i < count; ++i) {
    if (!decode_record(*r, s)) {
      if (r->error.empty()) r->error = "malformed record";
      return -1;
    }
  }
  return count;
}

// Feed an entire container-file BODY (everything after the header's sync
// marker): iterates blocks natively — count, byte size, payload, sync —
// so Python makes ONE GIL-releasing call per file. Returns total records
// decoded, -1 on decode error, -2 on framing/sync error.
int64_t pml_reader_feed_blocks(void* handle, const uint8_t* data,
                               int64_t start, int64_t len, int32_t codec,
                               const uint8_t* sync) {
  // `start` lets Python pass the whole mapped file and skip the header
  // without slicing a second full-size bytes object.
  Reader* r = static_cast<Reader*>(handle);
  Slice s{data + start, static_cast<size_t>(len - start)};
  int64_t total = 0;
  while (s.off < s.n) {
    int64_t count = read_long(s);
    int64_t nbytes = read_long(s);
    if (s.fail || count < 0 || nbytes < 0 ||
        !s.need(static_cast<size_t>(nbytes))) {
      r->error = "bad block framing";
      return -2;
    }
    const uint8_t* payload = s.p + s.off;
    s.off += static_cast<size_t>(nbytes);
    if (!s.need(16)) {
      r->error = "truncated sync marker";
      return -2;
    }
    if (std::memcmp(s.p + s.off, sync, 16) != 0) {
      r->error = "bad sync marker (corrupt file)";
      return -2;
    }
    s.off += 16;
    int64_t got = pml_reader_feed(handle, payload, nbytes, count, codec);
    if (got < 0) return -1;
    total += got;
  }
  return total;
}

}  // extern "C"

namespace {

struct BlockRef {
  const uint8_t* payload;
  int64_t nbytes;
  int64_t count;
};

bool scan_blocks(Slice& s, const uint8_t* sync, std::vector<BlockRef>& out,
                 std::string& err) {
  while (s.off < s.n) {
    int64_t count = read_long(s);
    int64_t nbytes = read_long(s);
    if (s.fail || count < 0 || nbytes < 0 ||
        !s.need(static_cast<size_t>(nbytes))) {
      err = "bad block framing";
      return false;
    }
    const uint8_t* payload = s.p + s.off;
    s.off += static_cast<size_t>(nbytes);
    if (!s.need(16)) {
      err = "truncated sync marker";
      return false;
    }
    if (std::memcmp(s.p + s.off, sync, 16) != 0) {
      err = "bad sync marker (corrupt file)";
      return false;
    }
    s.off += 16;
    out.push_back(BlockRef{payload, nbytes, count});
  }
  return true;
}

Reader* clone_config(const Reader& src) {
  Reader* r = new Reader();
  r->prog = src.prog;
  r->feat_wires = src.feat_wires;
  r->feat_optional = src.feat_optional;
  r->feat_name = src.feat_name;
  r->feat_term = src.feat_term;
  r->feat_value = src.feat_value;
  r->vocabset = src.vocabset;
  r->entity_keys = src.entity_keys;
  r->nscalars = src.nscalars;
  r->scalar_cols.resize(static_cast<size_t>(src.nscalars));
  r->scalar_seen.resize(static_cast<size_t>(src.nscalars));
  r->entities.resize(src.entity_keys.size());
  r->coo_rows.resize(src.coo_rows.size());
  r->coo_cols.resize(src.coo_cols.size());
  r->coo_vals.resize(src.coo_vals.size());
  r->collect_keys = src.collect_keys;
  return r;
}

// Append a sub-reader's accumulators in record order: columnar memcpy,
// string-pool offset shift, COO row-id shift by the running record base.
void merge_into(Reader& dst, Reader& sub) {
  int64_t row_base = dst.nrecords;
  for (int32_t c = 0; c < dst.nscalars; ++c) {
    auto& d = dst.scalar_cols[c];
    auto& s2 = sub.scalar_cols[c];
    d.insert(d.end(), s2.begin(), s2.end());
    auto& ds = dst.scalar_seen[c];
    auto& ss = sub.scalar_seen[c];
    ds.insert(ds.end(), ss.begin(), ss.end());
  }
  auto merge_pool = [](StringPool& d, const StringPool& s2) {
    int64_t base = static_cast<int64_t>(d.bytes.size());
    d.bytes.append(s2.bytes);
    for (size_t i = 1; i < s2.offsets.size(); ++i)
      d.offsets.push_back(s2.offsets[i] + base);
  };
  merge_pool(dst.uids, sub.uids);
  for (size_t e = 0; e < dst.entities.size(); ++e)
    merge_pool(dst.entities[e], sub.entities[e]);
  for (size_t vi = 0; vi < dst.coo_rows.size(); ++vi) {
    auto& dr = dst.coo_rows[vi];
    dr.reserve(dr.size() + sub.coo_rows[vi].size());
    for (int32_t row : sub.coo_rows[vi])
      dr.push_back(static_cast<int32_t>(row + row_base));
    auto& dc = dst.coo_cols[vi];
    dc.insert(dc.end(), sub.coo_cols[vi].begin(), sub.coo_cols[vi].end());
    auto& dv = dst.coo_vals[vi];
    dv.insert(dv.end(), sub.coo_vals[vi].begin(), sub.coo_vals[vi].end());
  }
  if (dst.collect_keys) dst.keyset.merge(sub.keyset);
  dst.nrecords += sub.nrecords;
}

}  // namespace

extern "C" {

// Multithreaded body decode: container blocks are independently framed
// (count + payload + sync) and the framing carries the record counts, so
// blocks scan cheaply up front, decode on `nthreads` threads into private
// accumulators, and merge back IN ORDER — output is bit-identical to the
// sequential path. This is the within-host analog of the reference
// decoding Avro across Spark executors (``avro/AvroIOUtils.scala:46-139``).
int64_t pml_reader_feed_blocks_mt(void* handle, const uint8_t* data,
                                  int64_t start, int64_t len, int32_t codec,
                                  const uint8_t* sync, int32_t nthreads) {
  Reader* r = static_cast<Reader*>(handle);
  Slice s{data + start, static_cast<size_t>(len - start)};
  std::vector<BlockRef> blocks;
  if (!scan_blocks(s, sync, blocks, r->error)) return -2;
  if (nthreads <= 1 || blocks.size() < 2) {
    int64_t total = 0;
    for (const BlockRef& b : blocks) {
      int64_t got = pml_reader_feed(handle, b.payload, b.nbytes, b.count,
                                    codec);
      if (got < 0) return -1;
      total += got;
    }
    return total;
  }
  size_t T = std::min<size_t>(static_cast<size_t>(nthreads), blocks.size());
  int64_t total_bytes = 0;
  for (const BlockRef& b : blocks) total_bytes += b.nbytes;
  // contiguous chunks balanced by compressed payload bytes
  std::vector<std::pair<size_t, size_t>> ranges;
  {
    size_t bi = 0;
    int64_t acc = 0;
    for (size_t t = 0; t < T && bi < blocks.size(); ++t) {
      int64_t target =
          total_bytes * static_cast<int64_t>(t + 1) / static_cast<int64_t>(T);
      size_t st = bi;
      while (bi < blocks.size() && (acc < target || bi == st))
        acc += blocks[bi++].nbytes;
      if (t == T - 1) bi = blocks.size();
      ranges.emplace_back(st, bi);
    }
  }
  std::vector<Reader*> subs;
  subs.reserve(ranges.size());
  for (size_t t = 0; t < ranges.size(); ++t) subs.push_back(clone_config(*r));
  std::vector<int64_t> rcs(ranges.size(), 0);
  std::vector<std::thread> threads;
  threads.reserve(ranges.size());
  for (size_t t = 0; t < ranges.size(); ++t) {
    threads.emplace_back([&, t]() {
      Reader* sr = subs[t];
      for (size_t b = ranges[t].first; b < ranges[t].second; ++b) {
        int64_t got = pml_reader_feed(sr, blocks[b].payload,
                                      blocks[b].nbytes, blocks[b].count,
                                      codec);
        if (got < 0) {
          rcs[t] = -1;
          return;
        }
        rcs[t] += got;
      }
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  bool fail = false;
  for (size_t t = 0; t < subs.size(); ++t) {
    if (rcs[t] < 0) {
      fail = true;
      if (r->error.empty())
        r->error = subs[t]->error.empty() ? "malformed record"
                                          : subs[t]->error;
    }
  }
  if (!fail) {
    for (Reader* sr : subs) {
      merge_into(*r, *sr);
      total += sr->nrecords;
    }
  }
  for (Reader* sr : subs) delete sr;
  return fail ? -1 : total;
}

int64_t pml_reader_nrecords(void* handle) {
  return static_cast<Reader*>(handle)->nrecords;
}

// sizes: out[0]=uid_bytes, then per entity key: bytes; per vocab: nnz
void pml_reader_sizes(void* handle, int64_t* out) {
  Reader* r = static_cast<Reader*>(handle);
  int k = 0;
  out[k++] = static_cast<int64_t>(r->uids.bytes.size());
  for (auto& e : r->entities) out[k++] = static_cast<int64_t>(e.bytes.size());
  for (auto& c : r->coo_rows) out[k++] = static_cast<int64_t>(c.size());
}

void pml_reader_scalar(void* handle, int32_t col, double* out,
                       uint8_t* seen_out) {
  Reader* r = static_cast<Reader*>(handle);
  auto& c = r->scalar_cols[col];
  std::memcpy(out, c.data(), c.size() * sizeof(double));
  auto& sflags = r->scalar_seen[col];
  if (seen_out) {
    // columns whose field exists carry one flag per record; a column whose
    // field is absent from the schema has no flags => never seen.
    std::memset(seen_out, 0, static_cast<size_t>(r->nrecords));
    std::memcpy(seen_out, sflags.data(), sflags.size());
  }
}

void pml_reader_strings(void* handle, int32_t which, int64_t* offsets,
                        char* bytes) {
  // which: -1 = uids, >=0 = entity pool
  Reader* r = static_cast<Reader*>(handle);
  StringPool& p = which < 0 ? r->uids : r->entities[which];
  std::memcpy(offsets, p.offsets.data(), p.offsets.size() * sizeof(int64_t));
  std::memcpy(bytes, p.bytes.data(), p.bytes.size());
}

void pml_reader_coo(void* handle, int32_t vocab, int32_t* rows, int32_t* cols,
                    double* vals) {
  Reader* r = static_cast<Reader*>(handle);
  auto& cr = r->coo_rows[vocab];
  std::memcpy(rows, cr.data(), cr.size() * sizeof(int32_t));
  std::memcpy(cols, r->coo_cols[vocab].data(),
              cr.size() * sizeof(int32_t));
  std::memcpy(vals, r->coo_vals[vocab].data(), cr.size() * sizeof(double));
}

// distinct-key export (vocabulary building): total byte size then data.
int64_t pml_reader_keys_bytes(void* handle, int64_t* nkeys_out) {
  Reader* r = static_cast<Reader*>(handle);
  int64_t total = 0;
  for (const auto& k : r->keyset) total += static_cast<int64_t>(k.size());
  *nkeys_out = static_cast<int64_t>(r->keyset.size());
  return total;
}

void pml_reader_keys(void* handle, int64_t* offsets, char* bytes) {
  Reader* r = static_cast<Reader*>(handle);
  int64_t off = 0;
  int64_t i = 0;
  offsets[0] = 0;
  for (const auto& k : r->keyset) {
    std::memcpy(bytes + off, k.data(), k.size());
    off += static_cast<int64_t>(k.size());
    offsets[++i] = off;
  }
}

const char* pml_reader_error(void* handle) {
  return static_cast<Reader*>(handle)->error.c_str();
}

void pml_reader_free(void* handle) { delete static_cast<Reader*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// columnar writer (the scoring driver's output path)
// ---------------------------------------------------------------------------
// Flat-record encoder: Python passes per-field write ops over columnar
// arrays; the container framing (header with schema JSON, deflate blocks,
// sync markers) is produced here. Schemas with arrays/maps of values fall
// back to the Python codec — the hot write path (ScoringResultAvro) is
// flat scalars + optional strings + always-null unions.

namespace {

enum WriteOp : int32_t {
  WOP_DOUBLE = 1,       // non-null double from column `arg`
  WOP_OPT_DOUBLE = 2,   // [null, double] union from column + present flags
  WOP_OPT_STRING = 3,   // [null, string] union from pool `arg`
  WOP_NULL_UNION = 4,   // union whose value is always null (branch 0)
  WOP_FLOAT = 5,        // non-null float (4-byte wire) from column `arg`
  WOP_OPT_FLOAT = 6,    // [null, float] union from column + present flags
};

void put_varlong(std::string& out, int64_t v) {
  uint64_t n = (static_cast<uint64_t>(v) << 1) ^
               static_cast<uint64_t>(v >> 63);
  while (true) {
    uint8_t b = n & 0x7F;
    n >>= 7;
    if (n) {
      out.push_back(static_cast<char>(b | 0x80));
    } else {
      out.push_back(static_cast<char>(b));
      return;
    }
  }
}

bool deflate_raw(const std::string& src, std::string& dst) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // raw deflate (windowBits -15), default level
  if (deflateInit2(&zs, Z_DEFAULT_COMPRESSION, Z_DEFLATED, -15, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return false;
  dst.resize(deflateBound(&zs, src.size()));
  zs.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(src.data()));
  zs.avail_in = static_cast<uInt>(src.size());
  zs.next_out = reinterpret_cast<Bytef*>(dst.data());
  zs.avail_out = static_cast<uInt>(dst.size());
  int rc = deflate(&zs, Z_FINISH);
  bool ok = rc == Z_STREAM_END;
  dst.resize(dst.size() - zs.avail_out);
  deflateEnd(&zs);
  return ok;
}

}  // namespace

extern "C" {

// Write an Avro container file of flat records from columnar arrays.
// ops: int32 pairs (op, arg). doubles: [ncols][n] row-major as one flat
// array. present: per optional-double column, n flags (may alias). pools:
// per string column, n+1 byte offsets + bytes (empty string == null).
// sync: 16 random bytes from the caller (the spec's per-file marker).
// codec: 0 = null, 1 = deflate. Returns 0 on success, negative on error.
int64_t pml_write_columnar(const char* path, const char* schema_json,
                           int64_t n, const int32_t* ops, int32_t nops,
                           const double* doubles,
                           const uint8_t* present_flags,
                           const int64_t* pool_offsets,
                           const char* pool_bytes, const char* sync,
                           int32_t codec, int64_t block_records) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  // header
  std::string header;
  header.append("Obj\x01", 4);
  put_varlong(header, 2);  // two metadata entries
  auto put_str = [&header](const std::string& s) {
    put_varlong(header, static_cast<int64_t>(s.size()));
    header.append(s);
  };
  put_str("avro.schema");
  put_str(schema_json);
  put_str("avro.codec");
  put_str(codec == 1 ? "deflate" : "null");
  put_varlong(header, 0);
  header.append(sync, 16);
  if (std::fwrite(header.data(), 1, header.size(), f) != header.size()) {
    std::fclose(f);
    return -2;
  }

  if (block_records <= 0) block_records = 4096;
  std::string block, packed, framed;
  // column layout bookkeeping: each op's `arg` indexes the shared arrays
  for (int64_t start = 0; start < n; start += block_records) {
    int64_t count = std::min(block_records, n - start);
    block.clear();
    for (int64_t i = start; i < start + count; ++i) {
      for (int32_t o = 0; o < nops; ++o) {
        int32_t op = ops[2 * o];
        int32_t arg = ops[2 * o + 1];
        switch (op) {
          case WOP_DOUBLE: {
            double v = doubles[static_cast<int64_t>(arg) * n + i];
            char buf[8];
            std::memcpy(buf, &v, 8);
            block.append(buf, 8);
            break;
          }
          case WOP_OPT_DOUBLE: {
            bool present =
                present_flags[static_cast<int64_t>(arg) * n + i] != 0;
            put_varlong(block, present ? 1 : 0);  // [null, double]
            if (present) {
              double v = doubles[static_cast<int64_t>(arg) * n + i];
              char buf[8];
              std::memcpy(buf, &v, 8);
              block.append(buf, 8);
            }
            break;
          }
          case WOP_OPT_STRING: {
            int64_t a = pool_offsets[static_cast<int64_t>(arg) * (n + 1) + i];
            int64_t b =
                pool_offsets[static_cast<int64_t>(arg) * (n + 1) + i + 1];
            if (b > a) {
              put_varlong(block, 1);  // [null, string]
              put_varlong(block, b - a);
              block.append(pool_bytes + a, static_cast<size_t>(b - a));
            } else {
              put_varlong(block, 0);
            }
            break;
          }
          case WOP_NULL_UNION:
            put_varlong(block, 0);
            break;
          case WOP_FLOAT: {
            float v = static_cast<float>(
                doubles[static_cast<int64_t>(arg) * n + i]);
            char buf[4];
            std::memcpy(buf, &v, 4);
            block.append(buf, 4);
            break;
          }
          case WOP_OPT_FLOAT: {
            bool present =
                present_flags[static_cast<int64_t>(arg) * n + i] != 0;
            put_varlong(block, present ? 1 : 0);  // [null, float]
            if (present) {
              float v = static_cast<float>(
                  doubles[static_cast<int64_t>(arg) * n + i]);
              char buf[4];
              std::memcpy(buf, &v, 4);
              block.append(buf, 4);
            }
            break;
          }
          default:
            std::fclose(f);
            return -3;
        }
      }
    }
    const std::string* payload = &block;
    if (codec == 1) {
      if (!deflate_raw(block, packed)) {
        std::fclose(f);
        return -4;
      }
      payload = &packed;
    }
    framed.clear();
    put_varlong(framed, count);
    put_varlong(framed, static_cast<int64_t>(payload->size()));
    framed.append(*payload);
    framed.append(sync, 16);
    if (std::fwrite(framed.data(), 1, framed.size(), f) != framed.size()) {
      std::fclose(f);
      return -2;
    }
  }
  if (std::fclose(f) != 0) return -2;
  return 0;
}

}  // extern "C"
