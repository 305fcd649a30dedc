// Native data-IO runtime of convnet_tpu_torch: a copy of the JAX
// package's native/dataio.cpp with the same C ABI (version 1).
//
// The counterpart of the reference's DataLoader worker processes for
// archive reads. The IO-bound half of the input pipeline runs in C++,
// outside Python's GIL:
//
//   1. tar_index:   single-pass scan of a (possibly >100 GB) POSIX/GNU
//                   tar archive, emitting (offset, size) per member —
//                   the byte-offset index the indexed-tar dataset
//                   serves from without unpacking 1.3M files.
//   2. batch_read:  positioned reads (pread) of many (offset, size)
//                   spans into one contiguous destination buffer,
//                   fanned out over a thread pool — the per-batch
//                   "gather samples from archive" step.
//
// IO/decode overlap lives in Python (data/loader.py read-ahead thread
// + bounded queue): batch_read releases the GIL inside its pread pool.
//
// A plain C ABI for ctypes. Built with g++ on first use by
// convnet_tpu_torch/ops/kernels/_build.py into convnet_tpu_torch/_build/;
// Python wrapper: convnet_tpu_torch/data/native.py (pure-Python
// fallback when it cannot be built or loaded).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// 1. tar indexing
// ---------------------------------------------------------------------------

// Parse an octal field (tar headers store sizes in ASCII octal; GNU tar
// may use base-256 for >8 GiB members: high bit of first byte set).
static int64_t parse_size(const unsigned char* p, size_t n) {
  if (p[0] & 0x80) {  // base-256
    int64_t v = p[0] & 0x7f;
    for (size_t i = 1; i < n; ++i) v = (v << 8) | p[i];
    return v;
  }
  int64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] >= '0' && p[i] <= '7') v = v * 8 + (p[i] - '0');
  }
  return v;
}

// Scan `tar_path`; for each regular-file member write (data_offset,
// size) into out_offsets/out_sizes (capacity `cap`), and append its
// NUL-terminated name to out_names (capacity name_cap bytes).
// Returns the number of members found, or -1 on error; if the capacity
// is insufficient, returns the required count without writing past cap
// (call once with cap=0 to size, then again).
int64_t ctpu_tar_index(const char* tar_path, int64_t* out_offsets,
                       int64_t* out_sizes, int64_t cap, char* out_names,
                       int64_t name_cap) {
  int fd = open(tar_path, O_RDONLY);
  if (fd < 0) return -1;
  unsigned char hdr[512];
  int64_t pos = 0;
  int64_t count = 0;
  int64_t name_pos = 0;
  int zero_blocks = 0;
  while (true) {
    ssize_t got = pread(fd, hdr, 512, pos);
    if (got < 512) break;
    bool all_zero = true;
    for (int i = 0; i < 512; ++i)
      if (hdr[i]) { all_zero = false; break; }
    if (all_zero) {
      if (++zero_blocks >= 2) break;
      pos += 512;
      continue;
    }
    zero_blocks = 0;
    int64_t size = parse_size(hdr + 124, 12);
    char typeflag = static_cast<char>(hdr[156]);
    // '0' or NUL = regular file; 'L' = GNU longname (data holds the
    // name for the NEXT header); others (dirs, links, pax) skipped.
    if (typeflag == '0' || typeflag == '\0') {
      if (count < cap) {
        out_offsets[count] = pos + 512;
        out_sizes[count] = size;
        // name: 100-byte field (+ optional "prefix" field at 345)
        char name[257];
        size_t n = 0;
        if (hdr[345] && hdr[257] == 'u') {  // ustar prefix present
          for (size_t i = 345; i < 500 && hdr[i] && n < 155; ++i)
            name[n++] = static_cast<char>(hdr[i]);
          if (n) name[n++] = '/';
        }
        for (size_t i = 0; i < 100 && hdr[i] && n < 256; ++i)
          name[n++] = static_cast<char>(hdr[i]);
        name[n++] = '\0';
        if (out_names && name_pos + static_cast<int64_t>(n) <= name_cap) {
          memcpy(out_names + name_pos, name, n);
        }
        name_pos += static_cast<int64_t>(n);
      }
      ++count;
    }
    int64_t blocks = (size + 511) / 512;
    pos += 512 + blocks * 512;
  }
  close(fd);
  return count;
}

// ---------------------------------------------------------------------------
// 2. batched positioned reads
// ---------------------------------------------------------------------------

// Read n spans (offsets[i], sizes[i]) from `path` into dst at
// dst_offsets[i], using `threads` worker threads. Returns 0 on success.
int ctpu_batch_read(const char* path, const int64_t* offsets,
                    const int64_t* sizes, const int64_t* dst_offsets,
                    int64_t n, unsigned char* dst, int threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t off = offsets[i];
      int64_t remaining = sizes[i];
      unsigned char* out = dst + dst_offsets[i];
      while (remaining > 0) {
        ssize_t got = pread(fd, out, static_cast<size_t>(remaining), off);
        if (got <= 0) { err.store(1); return; }
        remaining -= got;
        off += got;
        out += got;
      }
    }
  };
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  close(fd);
  return err.load() ? -2 : 0;
}

// ABI handshake — see ctpu_jpegdec_abi_version in jpegdec.cpp.
int64_t ctpu_dataio_abi_version(void) { return 1; }

}  // extern "C"
