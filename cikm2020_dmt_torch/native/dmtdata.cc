// dmtdata: the host-side data path's native half (the PyTorch port's own
// copy; it is built with g++ at first use by data/native.py).
//
// Replaces the hot host-side work the reference delegated to TensorFlow's
// C++ kernels (TFRecordDataset + parse_single_example + lookup tables,
// reference data_feed/tfrecord_mask.py:23-117, data_feed/index_tables.py):
//
//   * TFRecord framing scan (length-prefixed records)
//   * selective tf.train.Example wire decode
//   * vocab / OOV-bucket / hash id mapping (FNV-1a 64)
//   * fixed-shape padded batch assembly straight into caller-owned
//     numpy buffers, parallelized across a thread pool
//
// Exposed as a plain C ABI consumed via ctypes.  Semantics mirror the
// package's data/{tfrecord,example,vocab,pipeline}.py exactly;
// tests/test_torch_native.py asserts array-for-array batch equality.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// FNV-1a 64 (must match data/vocab.py)
// ---------------------------------------------------------------------------

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;

inline uint64_t Fnv1a64(const uint8_t* data, size_t n) {
  uint64_t h = kFnvOffset;
  for (size_t i = 0; i < n; ++i) {
    h = (h ^ data[i]) * kFnvPrime;
  }
  return h;
}

// ---------------------------------------------------------------------------
// Varint / proto helpers
// ---------------------------------------------------------------------------

inline bool ReadVarint(const uint8_t* buf, size_t end, size_t* i, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*i < end) {
    uint8_t b = buf[(*i)++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift >= 64) return false;
  }
  return false;
}

inline bool SkipField(const uint8_t* buf, size_t end, size_t* i, int wire) {
  switch (wire) {
    case 0: {  // varint
      uint64_t v;
      return ReadVarint(buf, end, i, &v);
    }
    case 1:
      *i += 8;
      return *i <= end;
    case 2: {
      uint64_t len;
      if (!ReadVarint(buf, end, i, &len)) return false;
      *i += len;
      return *i <= end;
    }
    case 5:
      *i += 4;
      return *i <= end;
    default:
      return false;
  }
}

// ---------------------------------------------------------------------------
// Flat open-addressing bytes->int32 map
// ---------------------------------------------------------------------------
//
// The parse hot loop does one map probe per Example map entry (slot lookup)
// plus one per id value (vocab lookup, ~10^2 per record for the click
// sequences).  std::unordered_map costs a std::string construction per
// probe (heap for keys >15B, e.g. sku ids) plus a node pointer chase; this
// flat table probes contiguous (hash, value) arrays with linear probing and
// reuses the FNV-1a hash the OOV fallback needs anyway.

struct FlatMap {
  std::string blob;            // concatenated key bytes (equality checks)
  std::vector<uint64_t> h_;    // [cap] cached full hash per occupied slot
  std::vector<int32_t> val_;   // [cap] value, -1 = empty
  std::vector<uint32_t> koff_;  // [cap] key offset into blob
  std::vector<uint32_t> klen_;  // [cap] key length
  uint64_t mask = 0;
  size_t size = 0;

  void Reserve(size_t n) {
    size_t cap = 16;
    while (cap < 2 * n + 1) cap <<= 1;  // load factor <= 0.5
    h_.assign(cap, 0);
    val_.assign(cap, -1);
    koff_.assign(cap, 0);
    klen_.assign(cap, 0);
    mask = cap - 1;
  }

  void Insert(const uint8_t* key, size_t n, int32_t value) {
    if (val_.empty()) Reserve(8);
    if (2 * (size + 1) > val_.size()) {  // grow: rebuild at 2x
      FlatMap bigger;
      bigger.Reserve(2 * val_.size());
      bigger.blob.reserve(blob.size() + n);
      for (size_t s = 0; s < val_.size(); ++s) {
        if (val_[s] >= 0) {
          bigger.Insert(reinterpret_cast<const uint8_t*>(blob.data()) +
                            koff_[s],
                        klen_[s], val_[s]);
        }
      }
      *this = std::move(bigger);
    }
    uint64_t h = Fnv1a64(key, n);
    size_t i = h & mask;
    while (val_[i] >= 0) {
      if (h_[i] == h && klen_[i] == n &&
          std::memcmp(blob.data() + koff_[i], key, n) == 0) {
        return;  // first insert wins (emplace semantics the map had)
      }
      i = (i + 1) & mask;
    }
    h_[i] = h;
    koff_[i] = static_cast<uint32_t>(blob.size());
    klen_[i] = static_cast<uint32_t>(n);
    val_[i] = value;
    blob.append(reinterpret_cast<const char*>(key), n);
    ++size;
  }

  // Caller supplies the precomputed FNV-1a hash of (key, n).
  inline int32_t Find(const uint8_t* key, size_t n, uint64_t h) const {
    if (val_.empty()) return -1;
    size_t i = h & mask;
    while (val_[i] >= 0) {
      if (h_[i] == h && klen_[i] == n &&
          std::memcmp(blob.data() + koff_[i], key, n) == 0) {
        return val_[i];
      }
      i = (i + 1) & mask;
    }
    return -1;
  }
};

// ---------------------------------------------------------------------------
// Schema / context
// ---------------------------------------------------------------------------

struct Table {
  int64_t id_size = 0;
  FlatMap vocab;
  int64_t NumOov() const {
    return id_size - static_cast<int64_t>(vocab.size);
  }
  int32_t Lookup(const uint8_t* v, size_t n) const {
    uint64_t h = Fnv1a64(v, n);
    if (vocab.size == 0) {
      return static_cast<int32_t>(h % static_cast<uint64_t>(id_size));
    }
    int32_t idx = vocab.Find(v, n, h);
    if (idx >= 0) return idx;
    int64_t oov = NumOov();
    if (oov > 0) {
      return static_cast<int32_t>(
          vocab.size + h % static_cast<uint64_t>(oov));
    }
    return 0;  // reference default_value=0
  }
};

struct IdFeature {
  std::string name;
  int max_len = 0;
  int table = -1;  // -1 => raw-int timestamp feature
};

// Per-feature output buffers for one batch (caller-owned numpy memory).
struct FeatureOut {
  int32_t* ids = nullptr;   // [B, max_len]
  float* wts = nullptr;     // [B, max_len]
  int32_t* len = nullptr;   // [B]
};

struct Ctx {
  int dense_dim = 0;
  int num_classes = 0;
  int header_cap = 0;
  int pos_field = 4;
  int page_field = 11;
  std::vector<Table> tables;
  std::vector<IdFeature> features;
  // name -> (kind << 24) | feature index. kinds: 0 dense, 1 label, 2 mask,
  // 3 header, 4 ids, 5 wts
  FlatMap slots;
  int num_threads = 0;

  void AddSlot(const std::string& name, int kind, int idx) {
    slots.Insert(reinterpret_cast<const uint8_t*>(name.data()), name.size(),
                 (kind << 24) | idx);
  }

  void Finalize() {
    slots = FlatMap();
    AddSlot("features", 0, 0);
    AddSlot("label", 1, 0);
    AddSlot("mask", 2, 0);
    AddSlot("header", 3, 0);
    for (size_t f = 0; f < features.size(); ++f) {
      AddSlot(features[f].name, 4, static_cast<int>(f));
      AddSlot(features[f].name + "Wts", 5, static_cast<int>(f));
    }
    if (num_threads <= 0) {
      num_threads = std::max(1u, std::thread::hardware_concurrency());
    }
  }
};

// Batch-output pointer set.
struct BatchOut {
  float* features;       // [B, dense_dim]
  float* label;          // [B]
  float* mask;           // [B, num_classes]
  uint8_t* header_buf;   // [B, header_cap]
  int32_t* header_len;   // [B]
  int32_t* em_position;  // [B]
  int32_t* em_page;      // [B]
  std::vector<FeatureOut> feats;
};

// ---------------------------------------------------------------------------
// Example parsing into one batch row
// ---------------------------------------------------------------------------

inline float ReadF32(const uint8_t* p) {
  float f;
  std::memcpy(&f, p, 4);
  return f;
}

// Parse a FloatList body into dst (cap values); returns count written.
int ParseFloatList(const uint8_t* buf, size_t start, size_t end, float* dst,
                   int cap) {
  size_t i = start;
  int n = 0;
  while (i < end) {
    uint64_t tag;
    if (!ReadVarint(buf, end, &i, &tag)) break;
    if ((tag & 7) == 2) {  // packed
      uint64_t len;
      if (!ReadVarint(buf, end, &i, &len)) break;
      size_t stop = i + len;
      while (i + 4 <= stop) {
        if (n < cap) dst[n] = ReadF32(buf + i);
        ++n;
        i += 4;
      }
      i = stop;
    } else if ((tag & 7) == 5) {
      if (n < cap) dst[n] = ReadF32(buf + i);
      ++n;
      i += 4;
    } else {
      if (!SkipField(buf, end, &i, tag & 7)) break;
    }
  }
  return std::min(n, cap);
}

// Visit each bytes value of a BytesList body.
template <typename F>
void ForEachBytes(const uint8_t* buf, size_t start, size_t end, F&& fn) {
  size_t i = start;
  while (i < end) {
    uint64_t tag;
    if (!ReadVarint(buf, end, &i, &tag)) break;
    if ((tag & 7) == 2) {
      uint64_t len;
      if (!ReadVarint(buf, end, &i, &len)) break;
      fn(buf + i, static_cast<size_t>(len));
      i += len;
    } else {
      if (!SkipField(buf, end, &i, tag & 7)) break;
    }
  }
}

inline int64_t ParseIntBytes(const uint8_t* v, size_t n) {
  // accepts "123" and "123.000000"; non-numeric -> 0
  int64_t out = 0;
  bool any = false;
  size_t i = 0;
  bool neg = false;
  if (n > 0 && (v[0] == '-' || v[0] == '+')) {
    neg = v[0] == '-';
    i = 1;
  }
  for (; i < n; ++i) {
    uint8_t c = v[i];
    if (c == '.') break;
    if (c < '0' || c > '9') return 0;
    out = out * 10 + (c - '0');
    any = true;
    if (out > (1LL << 40)) break;  // clamp later
  }
  if (!any) return 0;
  return neg ? -out : out;
}

void ParseOneExample(const Ctx& ctx, const uint8_t* rec, size_t rec_len,
                     int row, BatchOut* out) {
  const uint8_t* buf = rec;
  size_t i = 0, n = rec_len;
  // per-feature: did this record carry a non-empty Wts list?  (the
  // 1.0-fill below keys on true absence, matching the python assembler's
  // `if wts:` — genuinely all-zero weights must stay zero)
  std::vector<uint8_t> wts_seen(ctx.features.size(), 0);
  while (i < n) {
    uint64_t tag;
    if (!ReadVarint(buf, n, &i, &tag)) return;
    if ((tag >> 3) != 1 || (tag & 7) != 2) {
      if (!SkipField(buf, n, &i, tag & 7)) return;
      continue;
    }
    uint64_t feats_len;
    if (!ReadVarint(buf, n, &i, &feats_len)) return;
    size_t feats_end = i + feats_len;
    size_t j = i;
    while (j < feats_end) {
      uint64_t t2;
      if (!ReadVarint(buf, feats_end, &j, &t2)) return;
      if ((t2 & 7) != 2) {
        if (!SkipField(buf, feats_end, &j, t2 & 7)) return;
        continue;
      }
      uint64_t entry_len;
      if (!ReadVarint(buf, feats_end, &j, &entry_len)) return;
      size_t entry_end = j + entry_len;
      size_t k = j;
      const uint8_t* key = nullptr;
      size_t key_len = 0;
      size_t val_start = 0, val_end = 0;
      while (k < entry_end) {
        uint64_t t3;
        if (!ReadVarint(buf, entry_end, &k, &t3)) return;
        int f3 = t3 >> 3, w3 = t3 & 7;
        if (w3 != 2) {
          if (!SkipField(buf, entry_end, &k, w3)) return;
          continue;
        }
        uint64_t l3;
        if (!ReadVarint(buf, entry_end, &k, &l3)) return;
        if (f3 == 1) {
          key = buf + k;
          key_len = l3;
        } else if (f3 == 2) {
          val_start = k;
          val_end = k + l3;
        }
        k += l3;
      }
      j = entry_end;
      if (!key || val_start == 0) continue;
      int32_t packed = ctx.slots.Find(key, key_len, Fnv1a64(key, key_len));
      if (packed < 0) continue;

      // unwrap the Feature oneof: field 1 bytes_list / 2 float_list
      size_t vi = val_start;
      uint64_t vtag;
      if (!ReadVarint(buf, val_end, &vi, &vtag)) continue;
      uint64_t vlen;
      if ((vtag & 7) != 2 || !ReadVarint(buf, val_end, &vi, &vlen)) continue;
      size_t body_start = vi, body_end = vi + vlen;
      int vfield = vtag >> 3;  // 1 bytes, 2 float, 3 int64

      struct {
        int kind;
        int idx;
      } slot{packed >> 24, packed & 0xFFFFFF};
      switch (slot.kind) {
        case 0:  // dense features
          if (vfield == 2) {
            ParseFloatList(buf, body_start, body_end,
                           out->features + static_cast<size_t>(row) * ctx.dense_dim,
                           ctx.dense_dim);
          }
          break;
        case 1:  // label
          if (vfield == 2) {
            ParseFloatList(buf, body_start, body_end, out->label + row, 1);
          }
          break;
        case 2:  // mask
          if (vfield == 2) {
            ParseFloatList(buf, body_start, body_end,
                           out->mask + static_cast<size_t>(row) * ctx.num_classes,
                           ctx.num_classes);
          }
          break;
        case 3: {  // header
          if (vfield != 1) break;
          ForEachBytes(buf, body_start, body_end,
                       [&](const uint8_t* v, size_t vn) {
            if (out->header_buf) {  // null => caller skips header bytes
              size_t cap = static_cast<size_t>(ctx.header_cap);
              size_t cn = std::min(vn, cap);
              std::memcpy(out->header_buf + static_cast<size_t>(row) * cap,
                          v, cn);
              out->header_len[row] = static_cast<int32_t>(cn);
            }
            // header-derived position/page (tfrecord_mask.py:63-67)
            int field = 0;
            const int last = std::max(ctx.pos_field, ctx.page_field);
            size_t s = 0;
            for (size_t p = 0; p <= vn && field <= last; ++p) {
              if (p == vn || v[p] == '\t') {
                if (field == ctx.pos_field) {
                  int64_t x = ParseIntBytes(v + s, p - s);
                  out->em_position[row] =
                      static_cast<int32_t>(std::min<int64_t>(x, 400));
                } else if (field == ctx.page_field) {
                  int64_t x = ParseIntBytes(v + s, p - s);
                  out->em_page[row] =
                      static_cast<int32_t>(std::min<int64_t>(x, 100));
                }
                ++field;
                s = p + 1;
              }
            }
          });
          break;
        }
        case 4: {  // id feature values
          const IdFeature& f = ctx.features[slot.idx];
          FeatureOut& fo = out->feats[slot.idx];
          int32_t* ids = fo.ids + static_cast<size_t>(row) * f.max_len;
          int cnt = 0;
          if (vfield == 1) {
            ForEachBytes(buf, body_start, body_end,
                         [&](const uint8_t* v, size_t vn) {
              if (cnt >= f.max_len) {
                ++cnt;
                return;
              }
              if (f.table < 0) {
                int64_t x = ParseIntBytes(v, vn);
                ids[cnt] = static_cast<int32_t>(
                    std::min<int64_t>(std::max<int64_t>(x, 0), INT32_MAX));
              } else {
                ids[cnt] = ctx.tables[f.table].Lookup(v, vn);
              }
              ++cnt;
            });
          }
          fo.len[row] = std::min(cnt, f.max_len);
          break;
        }
        case 5: {  // id feature weights
          const IdFeature& f = ctx.features[slot.idx];
          FeatureOut& fo = out->feats[slot.idx];
          if (vfield == 2) {
            int wn = ParseFloatList(
                buf, body_start, body_end,
                fo.wts + static_cast<size_t>(row) * f.max_len, f.max_len);
            if (wn > 0) wts_seen[slot.idx] = 1;
          }
          break;
        }
      }
    }
    i = feats_end;
  }
  // Wts-absent fallback: present ids whose record carried no (non-empty)
  // weight list pool with weight 1.0, matching the python assembler
  // (pipeline.py BatchAssembler.assemble `if wts:` — explicit all-zero
  // weights stay zero; tests/test_torch_native.py).
  for (size_t f = 0; f < ctx.features.size(); ++f) {
    const IdFeature& feat = ctx.features[f];
    FeatureOut& fo = out->feats[f];
    int cnt = fo.len[row];
    float* w = fo.wts + static_cast<size_t>(row) * feat.max_len;
    // zero weights past the id count (python pads wts only to k)
    for (int c = cnt; c < feat.max_len; ++c) w[c] = 0.0f;
    if (cnt > 0 && !wts_seen[f]) {
      for (int c = 0; c < cnt; ++c) w[c] = 1.0f;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* dmt_ctx_create(int dense_dim, int num_classes, int header_cap,
                     int pos_field, int page_field, int num_threads) {
  auto* ctx = new Ctx();
  ctx->dense_dim = dense_dim;
  ctx->num_classes = num_classes;
  ctx->header_cap = header_cap;
  ctx->pos_field = pos_field;
  ctx->page_field = page_field;
  ctx->num_threads = num_threads;
  return ctx;
}

void dmt_ctx_destroy(void* p) { delete static_cast<Ctx*>(p); }

int dmt_ctx_add_table(void* p, int64_t id_size) {
  auto* ctx = static_cast<Ctx*>(p);
  ctx->tables.emplace_back();
  ctx->tables.back().id_size = id_size;
  return static_cast<int>(ctx->tables.size()) - 1;
}

// values: concatenated bytes; offsets: n+1 boundaries
void dmt_table_add_vocab(void* p, int table, const uint8_t* values,
                         const int64_t* offsets, int64_t n) {
  auto* ctx = static_cast<Ctx*>(p);
  Table& t = ctx->tables[table];
  t.vocab.Reserve(n);
  t.vocab.blob.reserve(offsets[n]);
  for (int64_t i = 0; i < n; ++i) {
    t.vocab.Insert(values + offsets[i],
                   static_cast<size_t>(offsets[i + 1] - offsets[i]),
                   static_cast<int32_t>(i));
  }
}

int dmt_ctx_add_feature(void* p, const char* name, int max_len, int table) {
  auto* ctx = static_cast<Ctx*>(p);
  ctx->features.push_back(IdFeature{name, max_len, table});
  return static_cast<int>(ctx->features.size()) - 1;
}

void dmt_ctx_finalize(void* p) { static_cast<Ctx*>(p)->Finalize(); }

// One-pass header-column extraction + factorization for offline metrics
// (metrics/offline.py ParsedHeaders): ``blob`` is the newline-joined
// header lines of one eval split.  For every line, parse tab-separated
// column ``label_field`` as an integer into labels[i], and map the byte
// values of columns ``sid_field`` / ``uuid_field`` to dense int32 codes
// in FIRST-OCCURRENCE order (pd.factorize semantics, so codes are
// byte-identical to the pandas path the tests compare against).  Returns
// the number of lines parsed, or -1 if it disagrees with n_expected.
// n_uniq[0]/n_uniq[1] receive the sid/uuid unique counts.
static int64_t FactorizeScan(FlatMap& sid_map, FlatMap& uuid_map,
                             const uint8_t* blob, int64_t blob_len,
                             int64_t n_expected, int label_field,
                             int sid_field, int uuid_field, int64_t* labels,
                             int32_t* sid_codes, int32_t* uuid_codes) {
  auto code_of = [](FlatMap& m, const uint8_t* v, size_t n) -> int32_t {
    uint64_t h = Fnv1a64(v, n);
    int32_t got = m.Find(v, n, h);
    if (got >= 0) return got;
    int32_t code = static_cast<int32_t>(m.size);
    m.Insert(v, n, code);
    return code;
  };
  const int last =
      std::max(label_field, std::max(sid_field, uuid_field));
  int64_t row = 0;
  int64_t i = 0;
  while (i <= blob_len && row < n_expected) {
    // line spans [i, eol)
    int64_t eol = i;
    while (eol < blob_len && blob[eol] != '\n') ++eol;
    int field = 0;
    int64_t s = i;
    for (int64_t p = i; p <= eol && field <= last; ++p) {
      if (p == eol || blob[p] == '\t') {
        const uint8_t* v = blob + s;
        size_t vn = static_cast<size_t>(p - s);
        if (field == label_field) labels[row] = ParseIntBytes(v, vn);
        if (field == sid_field) sid_codes[row] = code_of(sid_map, v, vn);
        if (field == uuid_field) uuid_codes[row] = code_of(uuid_map, v, vn);
        ++field;
        s = p + 1;
      }
    }
    if (field <= last) return -1;  // line too short for the schema
    ++row;
    i = eol + 1;
    if (eol == blob_len) break;
  }
  if (row != n_expected || i < blob_len) return -1;
  return row;
}

int64_t dmt_factorize_headers(const uint8_t* blob, int64_t blob_len,
                              int64_t n_expected, int label_field,
                              int sid_field, int uuid_field,
                              int64_t* labels, int32_t* sid_codes,
                              int32_t* uuid_codes, int64_t* n_uniq) {
  FlatMap sid_map, uuid_map;
  sid_map.Reserve(1024);
  uuid_map.Reserve(1024);
  int64_t row =
      FactorizeScan(sid_map, uuid_map, blob, blob_len, n_expected,
                    label_field, sid_field, uuid_field, labels, sid_codes,
                    uuid_codes);
  if (row < 0) return -1;
  n_uniq[0] = static_cast<int64_t>(sid_map.size);
  n_uniq[1] = static_cast<int64_t>(uuid_map.size);
  return row;
}

// Stateful (streaming) variant for reference-scale eval splits
// (reference metrics.py:134-199 fork-pools over a full in-RAM DataFrame;
// at its real 105.4M-row test split the raw headers alone are ~20 GB, so
// our eval loop feeds header lines chunk-by-chunk and keeps only the
// int64 labels + int32 group codes).  The FlatMaps copy key bytes into
// their own arena, so callers may free each chunk after feeding; resident
// state is O(unique sids + unique uuids), not O(rows).
struct HFact {
  FlatMap sid, uuid;
};

void* dmt_hfact_create() {
  auto* h = new HFact();
  h->sid.Reserve(1024);
  h->uuid.Reserve(1024);
  return h;
}

int64_t dmt_hfact_feed(void* p, const uint8_t* blob, int64_t blob_len,
                       int64_t n_expected, int label_field, int sid_field,
                       int uuid_field, int64_t* labels, int32_t* sid_codes,
                       int32_t* uuid_codes) {
  auto* h = static_cast<HFact*>(p);
  return FactorizeScan(h->sid, h->uuid, blob, blob_len, n_expected,
                       label_field, sid_field, uuid_field, labels,
                       sid_codes, uuid_codes);
}

// which: 0 = sid uniques, 1 = uuid uniques
int64_t dmt_hfact_uniques(void* p, int which) {
  auto* h = static_cast<HFact*>(p);
  return static_cast<int64_t>(which == 0 ? h->sid.size : h->uuid.size);
}

void dmt_hfact_destroy(void* p) { delete static_cast<HFact*>(p); }

// Batch vocab/OOV/hash id mapping for the serving request path: values is
// the concatenation of n raw byte ids, offsets its n+1 boundaries.  Same
// Table::Lookup semantics as batch parsing (data/vocab.py lookup_one).
void dmt_lookup_batch(void* p, int table, const uint8_t* values,
                      const int64_t* offsets, int64_t n, int32_t* out) {
  auto* ctx = static_cast<Ctx*>(p);
  const Table& t = ctx->tables[table];
  for (int64_t i = 0; i < n; ++i) {
    out[i] = t.Lookup(values + offsets[i],
                      static_cast<size_t>(offsets[i + 1] - offsets[i]));
  }
}

// Scan TFRecord framing in a file blob: fills offsets/lengths of payloads.
// Returns record count, or -1 on framing error.
int64_t dmt_scan_tfrecord(const uint8_t* blob, int64_t blob_len,
                          int64_t* offsets, int64_t* lengths,
                          int64_t max_records) {
  int64_t i = 0, n = 0;
  while (i + 12 <= blob_len && n < max_records) {
    uint64_t len;
    std::memcpy(&len, blob + i, 8);
    int64_t start = i + 12;
    int64_t end = start + static_cast<int64_t>(len) + 4;
    if (end > blob_len) return -1;
    offsets[n] = start;
    lengths[n] = static_cast<int64_t>(len);
    ++n;
    i = end;
  }
  return n;
}

// Parse n records (rows of one batch) in parallel into the given buffers.
// feats_* are arrays of per-feature pointers, laid out per dmt_ctx_add_feature
// order.  All buffers must be zero-initialized by the caller.
void dmt_parse_batch(void* p, const uint8_t* blob, const int64_t* offsets,
                     const int64_t* lengths, int64_t n_records,
                     float* features, float* label, float* mask,
                     uint8_t* header_buf, int32_t* header_len,
                     int32_t* em_position, int32_t* em_page,
                     int32_t** feat_ids, float** feat_wts,
                     int32_t** feat_len) {
  auto* ctx = static_cast<Ctx*>(p);
  BatchOut out;
  out.features = features;
  out.label = label;
  out.mask = mask;
  out.header_buf = header_buf;
  out.header_len = header_len;
  out.em_position = em_position;
  out.em_page = em_page;
  out.feats.resize(ctx->features.size());
  for (size_t f = 0; f < ctx->features.size(); ++f) {
    out.feats[f] = FeatureOut{feat_ids[f], feat_wts[f], feat_len[f]};
  }

  int threads = std::min<int64_t>(ctx->num_threads, n_records);
  if (threads <= 1) {
    for (int64_t r = 0; r < n_records; ++r) {
      ParseOneExample(*ctx, blob + offsets[r], lengths[r],
                      static_cast<int>(r), &out);
    }
    return;
  }
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&]() {
      constexpr int64_t kChunk = 16;
      while (true) {
        int64_t start = next.fetch_add(kChunk);
        if (start >= n_records) return;
        int64_t stop = std::min(start + kChunk, n_records);
        for (int64_t r = start; r < stop; ++r) {
          ParseOneExample(*ctx, blob + offsets[r], lengths[r],
                          static_cast<int>(r), &out);
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
