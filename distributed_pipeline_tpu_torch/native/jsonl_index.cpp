// Native jsonl corpus index: mmap + newline offset table, a copy of the
// JAX package's native/jsonl_index.cpp (the port builds its own copy).
//
// Holding every line of a corpus in a Python list costs O(corpus) host
// memory per process, paid again by every loader worker. Here the file is
// mmap'd read-only (pages stream in on demand, shared across processes by
// the page cache) and a single scan builds an offset table of non-blank
// lines. Random access is then one memcpy of one line.
//
// Line-splitting and blank-filtering match Python's text-mode file
// iteration exactly: terminators are \n, \r, and \r\n (universal
// newlines), and "blank" means every code point satisfies Python's
// str.isspace() — the same `ln.strip()` filter the Python fallback path
// applies. A corpus must index identically whether or not the native
// build succeeded.
//
// IMMUTABLE-CORPUS ASSUMPTION: the offset table is built once at open and
// the mapping is never revalidated. If the file is truncated or rewritten
// while a training run holds it open, later dpt_jsonl_get reads can touch
// unmapped pages and SIGBUS the process (the Python fallback, which copies
// lines at open, would not). Treat training corpora as append-never,
// replace-by-rename artifacts — the standard contract for mmap'd data.
//
// C ABI (ctypes, native/__init__.py):
//   dpt_jsonl_open(path)          -> handle | nullptr (open/mmap error)
//   dpt_jsonl_count(h)            -> number of non-blank lines
//   dpt_jsonl_get(h, i, buf, cap) -> byte length of line i (newline
//                                    stripped); copies min(len, cap) bytes;
//                                    -1 if i out of range
//   dpt_jsonl_close(h)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Index {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  // line i = [starts[i], starts[i] + lens[i])
  std::vector<size_t> starts;
  std::vector<size_t> lens;
};

// Python str.isspace() code points (CPython Unicode WS + bidirectional
// classes): ASCII 0x09-0x0D, 0x1C-0x1F, 0x20, then 0x85, 0xA0, 0x1680,
// 0x2000-0x200A, 0x2028, 0x2029, 0x202F, 0x205F, 0x3000.
bool IsPySpace(uint32_t cp) {
  return (cp >= 0x09 && cp <= 0x0D) || (cp >= 0x1C && cp <= 0x20) ||
         cp == 0x85 || cp == 0xA0 || cp == 0x1680 ||
         (cp >= 0x2000 && cp <= 0x200A) || cp == 0x2028 || cp == 0x2029 ||
         cp == 0x202F || cp == 0x205F || cp == 0x3000;
}

// Blank = every UTF-8 code point is Python whitespace (mirrors
// `ln.strip()` in the fallback). Malformed UTF-8 counts as non-blank —
// json.loads would fail on it either way, and "keep the line" matches
// what Python does with the undecodable-but-kept bytes it can read.
bool IsBlank(const char* s, size_t n) {
  size_t i = 0;
  while (i < n) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    uint32_t cp = c;
    size_t len = 1;
    if (c >= 0xF0) {
      len = 4;
    } else if (c >= 0xE0) {
      len = 3;
    } else if (c >= 0xC0) {
      len = 2;
    } else if (c >= 0x80) {
      return false;  // stray continuation byte
    }
    if (i + len > n) return false;
    if (len > 1) {
      cp = c & (0xFF >> (len + 1));
      for (size_t j = 1; j < len; ++j) {
        unsigned char cc = static_cast<unsigned char>(s[i + j]);
        if ((cc & 0xC0) != 0x80) return false;
        cp = (cp << 6) | (cc & 0x3F);
      }
    }
    if (!IsPySpace(cp)) return false;
    i += len;
  }
  return true;
}

}  // namespace

extern "C" {

void* dpt_jsonl_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 0) {
    ::close(fd);
    return nullptr;
  }
  auto idx = new Index();
  idx->fd = fd;
  idx->size = static_cast<size_t>(st.st_size);
  if (idx->size > 0) {
    void* p = mmap(nullptr, idx->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      ::close(fd);
      delete idx;
      return nullptr;
    }
    idx->data = static_cast<const char*>(p);
  }
  // Universal newlines: \n, \r, and \r\n all terminate a line (Python
  // text-mode file iteration).
  size_t start = 0;
  for (size_t i = 0; i <= idx->size; ++i) {
    bool at_end = (i == idx->size);
    char c = at_end ? '\0' : idx->data[i];
    if (at_end || c == '\n' || c == '\r') {
      size_t len = i - start;
      if (len > 0 && !IsBlank(idx->data + start, len)) {
        idx->starts.push_back(start);
        idx->lens.push_back(len);
      }
      if (c == '\r' && i + 1 < idx->size && idx->data[i + 1] == '\n') {
        ++i;  // \r\n is one terminator
      }
      start = i + 1;
    }
  }
  return idx;
}

int64_t dpt_jsonl_count(void* h) {
  return static_cast<int64_t>(static_cast<Index*>(h)->starts.size());
}

int64_t dpt_jsonl_get(void* h, int64_t i, uint8_t* buf, int64_t cap) {
  auto idx = static_cast<Index*>(h);
  if (i < 0 || i >= static_cast<int64_t>(idx->starts.size())) return -1;
  size_t n = idx->lens[static_cast<size_t>(i)];
  if (cap > 0) {
    std::memcpy(buf, idx->data + idx->starts[static_cast<size_t>(i)],
                std::min(n, static_cast<size_t>(cap)));
  }
  return static_cast<int64_t>(n);
}

void dpt_jsonl_close(void* h) {
  auto idx = static_cast<Index*>(h);
  if (idx->data) munmap(const_cast<char*>(idx->data), idx->size);
  if (idx->fd >= 0) ::close(idx->fd);
  delete idx;
}

}  // extern "C"
