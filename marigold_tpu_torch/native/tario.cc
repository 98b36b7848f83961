// tario — indexed, thread-safe tar member reader.
//
// Role: the data layer reads training samples out of multi-GB tar archives
// (reference reads them via Python tarfile, which does linear header scans
// and serializes member reads through a single file object —
// base_depth_dataset.py:193-204). This native reader scans the archive
// once to build a name->(offset,size) index, then serves members with
// positioned pread()s — lock-free and thread-safe, so the prefetch thread
// never blocks the training loop.
//
// Build: g++ -O2 -shared -fPIC -o libtario.so tario.cc
// ABI (ctypes):
//   void* tario_open(const char* path)
//   long  tario_count(void* h)
//   long  tario_member_size(void* h, const char* name)   // -1 if missing
//   long  tario_read(void* h, const char* name, unsigned char* buf, long cap)
//   long  tario_names(void* h, char* buf, long cap)      // \n-joined
//   void  tario_close(void* h)

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Member {
  uint64_t offset;
  uint64_t size;
};

struct TarIndex {
  int fd = -1;
  std::unordered_map<std::string, Member> members;
  std::vector<std::string> order;
};

uint64_t parse_octal(const char* p, size_t n) {
  // GNU tar base-256 extension for large sizes
  if (n > 0 && (static_cast<unsigned char>(p[0]) & 0x80)) {
    uint64_t v = static_cast<unsigned char>(p[0]) & 0x7f;
    for (size_t i = 1; i < n; ++i)
      v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  uint64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = v * 8 + static_cast<uint64_t>(p[i] - '0');
  }
  return v;
}

bool zero_block(const char* b) {
  for (int i = 0; i < 512; ++i)
    if (b[i]) return false;
  return true;
}

// canonical key: strip leading "./" so lookups match either spelling
std::string canon(const std::string& name) {
  if (name.rfind("./", 0) == 0) return name.substr(2);
  return name;
}

}  // namespace

extern "C" {

void* tario_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto* idx = new TarIndex();
  idx->fd = fd;

  char hdr[512];
  uint64_t off = 0;
  std::string pending_longname;
  int zeros = 0;
  while (true) {
    ssize_t r = ::pread(fd, hdr, 512, static_cast<off_t>(off));
    if (r < 512) break;
    if (zero_block(hdr)) {
      if (++zeros >= 2) break;
      off += 512;
      continue;
    }
    zeros = 0;

    uint64_t size = parse_octal(hdr + 124, 12);
    char typeflag = hdr[156];
    std::string name;
    if (!pending_longname.empty()) {
      name = pending_longname;
      pending_longname.clear();
    } else {
      char prefix[156] = {0};
      std::memcpy(prefix, hdr + 345, 155);
      char shortname[101] = {0};
      std::memcpy(shortname, hdr, 100);
      name = prefix[0] ? std::string(prefix) + "/" + shortname
                       : std::string(shortname);
    }

    uint64_t data_off = off + 512;
    uint64_t padded = (size + 511) / 512 * 512;

    if (typeflag == 'L') {  // GNU longname: data block holds the real name
      std::vector<char> buf(size + 1, 0);
      ::pread(fd, buf.data(), size, static_cast<off_t>(data_off));
      pending_longname.assign(buf.data());
    } else if (typeflag == 'x' || typeflag == 'X') {
      // PAX extended header (Python tarfile default): records of the form
      // "<len> key=value\n"; a "path" record overrides the next entry's name
      std::vector<char> buf(size, 0);
      ::pread(fd, buf.data(), size, static_cast<off_t>(data_off));
      size_t pos = 0;
      while (pos < size) {
        size_t sp = pos;
        while (sp < size && buf[sp] != ' ') ++sp;
        if (sp >= size) break;
        unsigned long rec_len = std::strtoul(&buf[pos], nullptr, 10);
        if (rec_len == 0 || pos + rec_len > size) break;
        std::string record(&buf[sp + 1], rec_len - (sp + 1 - pos) - 1);
        if (record.rfind("path=", 0) == 0)
          pending_longname = record.substr(5);
        pos += rec_len;
      }
    } else if (typeflag == 'g') {
      // pax global header: skip
    } else if (typeflag == '0' || typeflag == '\0') {  // regular file
      std::string key = canon(name);
      if (idx->members.emplace(key, Member{data_off, size}).second)
        idx->order.push_back(key);
    }
    off = data_off + padded;
  }
  return idx;
}

long tario_count(void* h) {
  if (!h) return -1;
  return static_cast<long>(static_cast<TarIndex*>(h)->members.size());
}

long tario_member_size(void* h, const char* name) {
  if (!h) return -1;
  auto* idx = static_cast<TarIndex*>(h);
  auto it = idx->members.find(canon(name));
  if (it == idx->members.end()) return -1;
  return static_cast<long>(it->second.size);
}

long tario_read(void* h, const char* name, unsigned char* buf, long cap) {
  if (!h) return -1;
  auto* idx = static_cast<TarIndex*>(h);
  auto it = idx->members.find(canon(name));
  if (it == idx->members.end()) return -1;
  uint64_t size = it->second.size;
  if (static_cast<uint64_t>(cap) < size) return -2;
  uint64_t done = 0;
  while (done < size) {
    ssize_t r = ::pread(idx->fd, buf + done, size - done,
                        static_cast<off_t>(it->second.offset + done));
    if (r <= 0) return -3;
    done += static_cast<uint64_t>(r);
  }
  return static_cast<long>(size);
}

long tario_names(void* h, char* buf, long cap) {
  if (!h) return -1;
  auto* idx = static_cast<TarIndex*>(h);
  std::string joined;
  for (const auto& n : idx->order) {
    joined += n;
    joined += '\n';
  }
  if (static_cast<long>(joined.size()) > cap)
    return -static_cast<long>(joined.size());
  std::memcpy(buf, joined.data(), joined.size());
  return static_cast<long>(joined.size());
}

void tario_close(void* h) {
  if (!h) return;
  auto* idx = static_cast<TarIndex*>(h);
  if (idx->fd >= 0) ::close(idx->fd);
  delete idx;
}

}  // extern "C"
