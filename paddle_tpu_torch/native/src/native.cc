// Native host runtime for the TPU framework: RecordIO container, bounded
// blocking record queue, and the multi-slot text data feed.
//
// Reference analogs (all C++ there too): paddle/fluid/recordio/ (chunk.{h,cc},
// scanner.{h,cc}, writer.{h,cc} — CRC-checked, compressed, seekable chunks),
// paddle/fluid/operators/reader/lod_tensor_blocking_queue.h:31 (bounded
// producer/consumer queue feeding the graph), and
// paddle/fluid/framework/data_feed.{h,cc} (MultiSlotDataFeed: slot-based text
// parsing on worker threads). The compute path is XLA; this is the host-side
// IO runtime the Python layer binds over ctypes
// (paddle_tpu/native/__init__.py).
//
// Chunk layout (inspired by recordio/README.md, not byte-compatible):
//   [magic u32 = 0x7061646C]["compressor" u32][num_records u32]
//   [raw_len u32][compressed_len u32][crc32-of-compressed u32]
//   [compressed payload: per record (len u32)(bytes)]
// A file is a sequence of chunks; scanners can shard a file by byte range:
// a scanner owns every chunk whose START offset lies in [begin, end).

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x7061646CU;  // "padl"
constexpr int kNoCompress = 0;
constexpr int kZlib = 1;

struct Chunk {
  std::vector<std::string> records;
  size_t num_bytes = 0;

  void Clear() {
    records.clear();
    num_bytes = 0;
  }

  bool Write(FILE* f, int compressor) {
    std::string payload;
    payload.reserve(num_bytes + records.size() * 4);
    for (const auto& r : records) {
      uint32_t len = static_cast<uint32_t>(r.size());
      payload.append(reinterpret_cast<const char*>(&len), 4);
      payload.append(r);
    }
    std::string out;
    if (compressor == kZlib) {
      uLongf bound = compressBound(payload.size());
      out.resize(bound);
      if (compress2(reinterpret_cast<Bytef*>(&out[0]), &bound,
                    reinterpret_cast<const Bytef*>(payload.data()),
                    payload.size(), Z_DEFAULT_COMPRESSION) != Z_OK) {
        return false;
      }
      out.resize(bound);
    } else {
      out = payload;
    }
    uint32_t header[6] = {
        kMagic,
        static_cast<uint32_t>(compressor),
        static_cast<uint32_t>(records.size()),
        static_cast<uint32_t>(payload.size()),
        static_cast<uint32_t>(out.size()),
        static_cast<uint32_t>(
            crc32(0, reinterpret_cast<const Bytef*>(out.data()), out.size())),
    };
    if (fwrite(header, sizeof(header), 1, f) != 1) return false;
    if (!out.empty() && fwrite(out.data(), out.size(), 1, f) != 1) return false;
    return true;
  }

  // returns 1 ok, 0 clean eof, -1 corrupt
  int Read(FILE* f) {
    Clear();
    uint32_t header[6];
    size_t n = fread(header, sizeof(uint32_t), 6, f);
    if (n == 0) return 0;
    if (n != 6 || header[0] != kMagic) return -1;
    uint32_t compressor = header[1], num = header[2], raw_len = header[3],
             comp_len = header[4], crc = header[5];
    // sanity-bound header-declared sizes by what the file can actually hold
    // (a corrupt header must return -2, not throw bad_alloc on a 4GB resize)
    long cur = ftell(f);
    if (fseek(f, 0, SEEK_END) != 0) return -1;
    long file_end = ftell(f);
    if (fseek(f, cur, SEEK_SET) != 0) return -1;
    if (static_cast<long>(comp_len) > file_end - cur) return -1;
    if (raw_len > (64UL << 20) + 16 * comp_len + (64UL << 10)) return -1;
    std::string buf(comp_len, '\0');
    if (comp_len && fread(&buf[0], 1, comp_len, f) != comp_len) return -1;
    if (crc32(0, reinterpret_cast<const Bytef*>(buf.data()), buf.size()) != crc)
      return -1;
    std::string payload;
    if (compressor == kZlib) {
      payload.resize(raw_len);
      uLongf dlen = raw_len;
      if (uncompress(reinterpret_cast<Bytef*>(&payload[0]), &dlen,
                     reinterpret_cast<const Bytef*>(buf.data()),
                     buf.size()) != Z_OK ||
          dlen != raw_len)
        return -1;
    } else {
      payload = std::move(buf);
    }
    // num_records is header-declared and not CRC-protected: bound it by the
    // payload (each record costs >= 4 header bytes) before reserving
    if (num > payload.size() / 4 + 1) return -1;
    size_t pos = 0;
    records.reserve(num);
    for (uint32_t i = 0; i < num; ++i) {
      if (pos + 4 > payload.size()) return -1;
      uint32_t len;
      memcpy(&len, payload.data() + pos, 4);
      pos += 4;
      if (pos + len > payload.size()) return -1;
      records.emplace_back(payload.data() + pos, len);
      num_bytes += len;
      pos += len;
    }
    return 1;
  }
};

struct Writer {
  FILE* f = nullptr;
  Chunk chunk;
  int compressor = kZlib;
  size_t max_records = 1000;
  size_t max_bytes = 16 << 20;
};

struct Scanner {
  FILE* f = nullptr;
  Chunk chunk;
  size_t idx = 0;       // next record within chunk
  long end = -1;        // byte-range shard limit (chunk starts < end)
  std::string current;  // buffer handed to the caller
};

struct BlockingQueue {
  std::deque<std::string> items;
  size_t capacity;
  bool closed = false;
  std::mutex mu;
  std::condition_variable not_full, not_empty;

  explicit BlockingQueue(size_t cap) : capacity(cap) {}

  bool Push(std::string v) {
    std::unique_lock<std::mutex> lk(mu);
    not_full.wait(lk, [&] { return closed || items.size() < capacity; });
    if (closed) return false;
    items.push_back(std::move(v));
    not_empty.notify_one();
    return true;
  }

  // 1 ok, 0 closed-and-drained
  int Pop(std::string* out) {
    std::unique_lock<std::mutex> lk(mu);
    not_empty.wait(lk, [&] { return closed || !items.empty(); });
    if (items.empty()) return 0;
    *out = std::move(items.front());
    items.pop_front();
    not_full.notify_one();
    return 1;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu);
    closed = true;
    not_full.notify_all();
    not_empty.notify_all();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu);
    return items.size();
  }
};

// Multi-slot text feed: N worker threads pull file paths off a work list,
// parse lines, and push packed binary samples into a BlockingQueue.
//
// Text line format (reference data_feed.cc MultiSlotDataFeed): for each slot
// in declared order: <n> <v1> ... <vn>, whitespace-separated.
// Packed sample: [nslots u32] then per slot [dtype u8: 0=int64, 1=float32]
// [n u32][values].
struct MultiSlotFeed {
  std::vector<uint8_t> slot_types;  // 0 int64, 1 float32
  std::vector<std::string> files;
  BlockingQueue* queue = nullptr;
  std::vector<std::thread> workers;
  std::atomic<size_t> next_file{0};
  std::atomic<long> parse_errors{0};
  std::atomic<long> file_errors{0};  // unopenable shards — a loud failure

  void ParseLine(const char* line, std::string* out) {
    const char* p = line;
    uint32_t nslots = slot_types.size();
    out->clear();
    out->append(reinterpret_cast<const char*>(&nslots), 4);
    for (uint32_t s = 0; s < nslots; ++s) {
      char* q;
      long n = strtol(p, &q, 10);
      if (q == p || n < 0) throw std::runtime_error("bad slot count");
      p = q;
      uint8_t t = slot_types[s];
      uint32_t n32 = static_cast<uint32_t>(n);
      out->push_back(static_cast<char>(t));
      out->append(reinterpret_cast<const char*>(&n32), 4);
      for (long i = 0; i < n; ++i) {
        if (t == 0) {
          long long v = strtoll(p, &q, 10);
          if (q == p) throw std::runtime_error("bad int value");
          int64_t v64 = v;
          out->append(reinterpret_cast<const char*>(&v64), 8);
        } else {
          float v = strtof(p, &q);
          if (q == p) throw std::runtime_error("bad float value");
          out->append(reinterpret_cast<const char*>(&v), 4);
        }
        p = q;
      }
    }
  }

  // gzip-transparent line iteration (reference CTRReader reads .gz shards;
  // gzFile handles plain files too, so every input goes through zlib)
  void Run() {
    std::string packed;
    std::string line;
    std::vector<char> buf(1 << 16);
    bool queue_closed = false;
    for (;;) {
      if (queue_closed) break;  // consumer gone: skip remaining files
      size_t i = next_file.fetch_add(1);
      if (i >= files.size()) break;
      gzFile f = gzopen(files[i].c_str(), "rb");
      if (!f) {
        file_errors.fetch_add(1);
        continue;
      }
      while (!queue_closed && gzgets(f, buf.data(), buf.size()) != nullptr) {
        line.assign(buf.data());
        // reassemble lines longer than one buffer
        while (!line.empty() && line.back() != '\n' &&
               gzgets(f, buf.data(), buf.size()) != nullptr) {
          line.append(buf.data());
        }
        if (line.empty() || line[0] == '\n') continue;
        try {
          ParseLine(line.c_str(), &packed);
        } catch (...) {
          parse_errors.fetch_add(1);
          continue;
        }
        if (!queue->Push(packed)) queue_closed = true;
      }
      // gzgets returning NULL mid-file on a corrupt/truncated stream must
      // not masquerade as clean EOF
      int errnum = Z_OK;
      gzerror(f, &errnum);
      if (errnum != Z_OK && errnum != Z_STREAM_END) file_errors.fetch_add(1);
      gzclose(f);
    }
  }
};

}  // namespace

extern "C" {

// ------------------------------- RecordIO ---------------------------------

void* rio_writer_open(const char* path, int compressor, long max_records,
                      long max_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  w->compressor = compressor;
  if (max_records > 0) w->max_records = max_records;
  if (max_bytes > 0) w->max_bytes = max_bytes;
  return w;
}

int rio_writer_write(void* hw, const char* data, long len) {
  Writer* w = static_cast<Writer*>(hw);
  w->chunk.records.emplace_back(data, len);
  w->chunk.num_bytes += len;
  if (w->chunk.records.size() >= w->max_records ||
      w->chunk.num_bytes >= w->max_bytes) {
    if (!w->chunk.Write(w->f, w->compressor)) return -1;
    w->chunk.Clear();
  }
  return 0;
}

int rio_writer_close(void* hw) {
  Writer* w = static_cast<Writer*>(hw);
  int rc = 0;
  if (!w->chunk.records.empty() && !w->chunk.Write(w->f, w->compressor))
    rc = -1;
  fclose(w->f);
  delete w;
  return rc;
}

void* rio_scanner_open(const char* path, long begin, long end) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Scanner* s = new Scanner();
  s->f = f;
  s->end = end;
  if (begin > 0) fseek(f, begin, SEEK_SET);
  return s;
}

// record length, -1 = eof, -2 = corrupt file
long rio_scanner_next(void* hs, const char** out) {
  Scanner* s = static_cast<Scanner*>(hs);
  while (s->idx >= s->chunk.records.size()) {
    long pos = ftell(s->f);
    if (s->end >= 0 && pos >= s->end) return -1;  // next chunk beyond shard
    int rc = s->chunk.Read(s->f);
    if (rc == 0) return -1;
    if (rc < 0) return -2;
    s->idx = 0;
  }
  s->current = std::move(s->chunk.records[s->idx++]);
  *out = s->current.data();
  return static_cast<long>(s->current.size());
}

void rio_scanner_close(void* hs) {
  Scanner* s = static_cast<Scanner*>(hs);
  fclose(s->f);
  delete s;
}

// Chunk start offsets (for range-sharding across trainers, the Go master's
// chunk/task model, go/master/service.go:69). Returns count, fills up to cap.
long rio_chunk_offsets(const char* path, long* offsets, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long count = 0;
  for (;;) {
    long pos = ftell(f);
    uint32_t header[6];
    if (fread(header, sizeof(uint32_t), 6, f) != 6) break;
    if (header[0] != kMagic) {
      count = -2;
      break;
    }
    if (count < cap && offsets) offsets[count] = pos;
    ++count;
    if (fseek(f, header[4], SEEK_CUR) != 0) break;
  }
  fclose(f);
  return count;
}

// ---------------------------- blocking queue ------------------------------

void* bq_create(long capacity) {
  return new BlockingQueue(capacity > 0 ? capacity : 1);
}

int bq_push(void* hq, const char* data, long len) {
  return static_cast<BlockingQueue*>(hq)->Push(std::string(data, len)) ? 0 : -1;
}

// caller provides out buffer via bq_pop_copy two-phase: first call returns
// size with keep=1, second copies. Simpler: allocate and hand ownership.
long bq_pop(void* hq, char** out) {
  std::string item;
  int rc = static_cast<BlockingQueue*>(hq)->Pop(&item);
  if (rc == 0) return -1;
  char* buf = static_cast<char*>(malloc(item.size()));
  memcpy(buf, item.data(), item.size());
  *out = buf;
  return static_cast<long>(item.size());
}

void bq_free(char* buf) { free(buf); }

void bq_close(void* hq) { static_cast<BlockingQueue*>(hq)->Close(); }

long bq_size(void* hq) {
  return static_cast<long>(static_cast<BlockingQueue*>(hq)->Size());
}

void bq_destroy(void* hq) { delete static_cast<BlockingQueue*>(hq); }

// --------------------------- multi-slot feed ------------------------------

// slot_types: array of 0 (int64) / 1 (float32) per slot
void* msdf_create(const uint8_t* slot_types, int nslots) {
  MultiSlotFeed* m = new MultiSlotFeed();
  m->slot_types.assign(slot_types, slot_types + nslots);
  return m;
}

int msdf_start(void* hm, const char** files, int nfiles, int nthreads,
               void* hq) {
  MultiSlotFeed* m = static_cast<MultiSlotFeed*>(hm);
  if (!m->workers.empty()) return -1;
  m->files.assign(files, files + nfiles);
  m->queue = static_cast<BlockingQueue*>(hq);
  for (int i = 0; i < (nthreads > 0 ? nthreads : 1); ++i) {
    m->workers.emplace_back([m] { m->Run(); });
  }
  return 0;
}

// joins workers; returns number of parse errors encountered
long msdf_join(void* hm) {
  MultiSlotFeed* m = static_cast<MultiSlotFeed*>(hm);
  for (auto& t : m->workers) t.join();
  m->workers.clear();
  return m->parse_errors.load();
}

long msdf_file_errors(void* hm) {
  return static_cast<MultiSlotFeed*>(hm)->file_errors.load();
}

void msdf_destroy(void* hm) { delete static_cast<MultiSlotFeed*>(hm); }

}  // extern "C"
