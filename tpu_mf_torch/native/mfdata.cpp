// Native data plane of the PyTorch port (a copy of tpu_mf's): fast
// parse/write of the reference's length-prefixed protobuf block streams ([uint32 size][mf.Block] frames,
// reference framing: data/getdata.cc:100-103, reader src/util.h:76-88;
// schema src/blocks.proto:1-18).
//
// Implemented directly against the protobuf wire format (three fields:
// Block.user=1 LEN, User.uid=1 VARINT, User.record=2 LEN, Record.vid=1
// VARINT, Record.rating=2 F32) — no libprotobuf dependency. Exposed as a
// C ABI for ctypes (tpu_mf_torch/native/__init__.py), which builds it with
// the host C++ compiler at first use into build/libmfdata-<hash>.so.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTagUser = (1u << 3) | 2;    // Block.user
constexpr uint32_t kTagUid = (1u << 3) | 0;     // User.uid
constexpr uint32_t kTagRecord = (2u << 3) | 2;  // User.record
constexpr uint32_t kTagVid = (1u << 3) | 0;     // Record.vid
constexpr uint32_t kTagRating = (2u << 3) | 5;  // Record.rating

inline bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (p < end) {
    uint8_t b = *p++;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

inline void write_varint(std::vector<uint8_t>& out, uint64_t v) {
  while (true) {
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) {
      out.push_back(b | 0x80);
    } else {
      out.push_back(b);
      return;
    }
  }
}

// Parse one serialized Block; append (u, v, r) triples. Returns count or -1.
long long parse_block(const uint8_t* buf, size_t len, int32_t* u, int32_t* v,
                      float* r, long long cap, long long n) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  while (p < end) {
    uint64_t tag, ulen;
    if (!read_varint(p, end, &tag) || tag != kTagUser) return -1;
    if (!read_varint(p, end, &ulen)) return -1;
    const uint8_t* uend = p + ulen;
    if (uend > end) return -1;
    uint64_t uid = 0;
    while (p < uend) {
      uint64_t utag;
      if (!read_varint(p, uend, &utag)) return -1;
      if (utag == kTagUid) {
        if (!read_varint(p, uend, &uid)) return -1;
      } else if (utag == kTagRecord) {
        uint64_t rlen;
        if (!read_varint(p, uend, &rlen)) return -1;
        const uint8_t* rend = p + rlen;
        if (rend > uend) return -1;
        uint64_t vid = 0;
        float rating = 0.0f;
        while (p < rend) {
          uint64_t rtag;
          if (!read_varint(p, rend, &rtag)) return -1;
          if (rtag == kTagVid) {
            if (!read_varint(p, rend, &vid)) return -1;
          } else if (rtag == kTagRating) {
            if (p + 4 > rend) return -1;
            memcpy(&rating, p, 4);
            p += 4;
          } else {
            return -1;
          }
        }
        if (u != nullptr) {
          if (n >= cap) return -1;
          u[n] = static_cast<int32_t>(uid);
          v[n] = static_cast<int32_t>(vid);
          r[n] = rating;
        }
        ++n;
      } else {
        return -1;
      }
    }
  }
  return n;
}

long long scan_file(const char* path, int32_t* u, int32_t* v, float* r,
                    long long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -2;
  std::vector<uint8_t> buf;
  long long n = 0;
  while (true) {
    uint32_t size;
    size_t got = fread(&size, 1, sizeof(size), f);
    if (got == 0) break;
    if (got != sizeof(size)) {
      fclose(f);
      return -3;
    }
    buf.resize(size);
    if (fread(buf.data(), 1, size, f) != size) {
      fclose(f);
      return -3;
    }
    n = parse_block(buf.data(), size, u, v, r, cap, n);
    if (n < 0) {
      fclose(f);
      return -4;
    }
  }
  fclose(f);
  return n;
}

}  // namespace

extern "C" {

// Count ratings in a block-stream file (first pass for allocation).
long long mfdata_count_frames(const char* path) {
  return scan_file(path, nullptr, nullptr, nullptr, 0);
}

// Parse the file into preallocated arrays of capacity cap; returns count.
long long mfdata_parse_frames(const char* path, int32_t* u, int32_t* v,
                              float* r, long long cap) {
  return scan_file(path, u, v, r, cap);
}

// Write (u, v, r) — already sorted/grouped by u — as a block stream with
// users_per_block users per frame (reference default 1000, getdata.cc:19).
long long mfdata_write_frames(const char* path, const int32_t* u,
                              const int32_t* v, const float* r, long long n,
                              int users_per_block) {
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  std::vector<uint8_t> block;
  std::vector<uint8_t> user;
  std::vector<uint8_t> rec;
  long long i = 0;
  long long frames = 0;
  while (i < n) {
    block.clear();
    int users = 0;
    while (i < n && users < users_per_block) {
      int32_t uid = u[i];
      user.clear();
      write_varint(user, kTagUid);
      write_varint(user, static_cast<uint64_t>(uid));
      while (i < n && u[i] == uid) {
        rec.clear();
        write_varint(rec, kTagVid);
        write_varint(rec, static_cast<uint64_t>(v[i]));
        write_varint(rec, kTagRating);
        uint8_t fb[4];
        memcpy(fb, &r[i], 4);
        rec.insert(rec.end(), fb, fb + 4);
        write_varint(user, kTagRecord);
        write_varint(user, rec.size());
        user.insert(user.end(), rec.begin(), rec.end());
        ++i;
      }
      write_varint(block, kTagUser);
      write_varint(block, user.size());
      block.insert(block.end(), user.begin(), user.end());
      ++users;
    }
    uint32_t size = static_cast<uint32_t>(block.size());
    if (fwrite(&size, 1, sizeof(size), f) != sizeof(size) ||
        fwrite(block.data(), 1, size, f) != size) {
      fclose(f);
      return -3;
    }
    ++frames;
  }
  fclose(f);
  return frames;
}

}  // extern "C"
