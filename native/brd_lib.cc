// brd_lib: native codebook-image library for the 2ACE stack.
//
// Fills the role of the closed-source `wil6210_brd_mod` binary the reference
// shells out to for every codebook edit (ref: main/codebook_library.py:21-48,
// codebook/generate_rx_codebook_16ant_random.py:16-23): create a codebook
// image file, write/read per-sector per-antenna amplitude+phase codes, set
// the active sector count, and toggle RF-module enable masks.  The
// proprietary .brd layout is undocumented, so this defines an open "TBRD"
// container with the same information content:
//
//   header:  magic "TBRD" | u32 version | u32 n_ant | u32 n_sectors
//            | u32 active_sectors | u32 module_mask | u32 checksum
//   payload: n_sectors x (n_ant amp bytes, n_ant phase bytes)
//
// The checksum is a simple 32-bit sum over the payload, re-computed on every
// write; readers reject images whose checksum mismatches (truncated/corrupt
// flash images are the reference's most common operational failure,
// README.md:89-96).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -o libtbrd.so brd_lib.cc
// All functions return 0 on success, negative codes on error.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x44524254;  // "TBRD" little-endian
constexpr uint32_t kVersion = 1;

struct Header {
  uint32_t magic;
  uint32_t version;
  uint32_t n_ant;
  uint32_t n_sectors;
  uint32_t active_sectors;
  uint32_t module_mask;
  uint32_t checksum;
};

enum Err {
  kOk = 0,
  kErrIo = -1,
  kErrFormat = -2,
  kErrRange = -3,
  kErrChecksum = -4,
};

uint32_t payload_sum(const std::vector<uint8_t>& payload) {
  uint32_t s = 0;
  for (uint8_t b : payload) s = s * 31u + b;
  return s;
}

int load(const char* path, Header* hdr, std::vector<uint8_t>* payload) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kErrIo;
  if (std::fread(hdr, sizeof(Header), 1, f) != 1) {
    std::fclose(f);
    return kErrFormat;
  }
  if (hdr->magic != kMagic || hdr->version != kVersion) {
    std::fclose(f);
    return kErrFormat;
  }
  size_t n = size_t(hdr->n_sectors) * hdr->n_ant * 2;
  payload->resize(n);
  size_t got = n ? std::fread(payload->data(), 1, n, f) : 0;
  std::fclose(f);
  if (got != n) return kErrFormat;
  if (payload_sum(*payload) != hdr->checksum) return kErrChecksum;
  return kOk;
}

int store(const char* path, Header hdr, const std::vector<uint8_t>& payload) {
  hdr.checksum = payload_sum(payload);
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return kErrIo;
  bool ok = std::fwrite(&hdr, sizeof(Header), 1, f) == 1 &&
            (payload.empty() ||
             std::fwrite(payload.data(), 1, payload.size(), f) ==
                 payload.size());
  ok = (std::fclose(f) == 0) && ok;
  if (!ok) {
    std::remove(tmp.c_str());
    return kErrIo;
  }
  if (std::rename(tmp.c_str(), path) != 0) {
    std::remove(tmp.c_str());
    return kErrIo;
  }
  return kOk;
}

}  // namespace

extern "C" {

int tbrd_create(const char* path, int n_ant, int n_sectors) {
  if (n_ant <= 0 || n_sectors <= 0 || n_ant > 4096 || n_sectors > 65536)
    return kErrRange;
  Header hdr{kMagic, kVersion, uint32_t(n_ant), uint32_t(n_sectors),
             uint32_t(n_sectors), 0xFFFFFFFFu, 0};
  std::vector<uint8_t> payload(size_t(n_sectors) * n_ant * 2, 0);
  return store(path, hdr, payload);
}

int tbrd_get_info(const char* path, int* n_ant, int* n_sectors,
                  int* active_sectors, uint32_t* module_mask) {
  Header hdr;
  std::vector<uint8_t> payload;
  int rc = load(path, &hdr, &payload);
  if (rc != kOk) return rc;
  if (n_ant) *n_ant = int(hdr.n_ant);
  if (n_sectors) *n_sectors = int(hdr.n_sectors);
  if (active_sectors) *active_sectors = int(hdr.active_sectors);
  if (module_mask) *module_mask = hdr.module_mask;
  return kOk;
}

// Write one sector's per-antenna amplitude and phase codes
// (the `wil6210_brd_mod -set_beam` role, codebook_library.py:21-30).
int tbrd_set_beam(const char* path, int sector, const uint8_t* amp,
                  const uint8_t* phase, int n_ant) {
  Header hdr;
  std::vector<uint8_t> payload;
  int rc = load(path, &hdr, &payload);
  if (rc != kOk) return rc;
  if (sector < 0 || uint32_t(sector) >= hdr.n_sectors ||
      uint32_t(n_ant) != hdr.n_ant)
    return kErrRange;
  uint8_t* dst = payload.data() + size_t(sector) * hdr.n_ant * 2;
  std::memcpy(dst, amp, n_ant);
  std::memcpy(dst + n_ant, phase, n_ant);
  return store(path, hdr, payload);
}

int tbrd_get_beam(const char* path, int sector, uint8_t* amp, uint8_t* phase,
                  int n_ant) {
  Header hdr;
  std::vector<uint8_t> payload;
  int rc = load(path, &hdr, &payload);
  if (rc != kOk) return rc;
  if (sector < 0 || uint32_t(sector) >= hdr.n_sectors ||
      uint32_t(n_ant) != hdr.n_ant)
    return kErrRange;
  const uint8_t* src = payload.data() + size_t(sector) * hdr.n_ant * 2;
  std::memcpy(amp, src, n_ant);
  std::memcpy(phase, src + n_ant, n_ant);
  return kOk;
}

// Bulk write of all sectors in one I/O pass (no reference analog — the
// reference re-launches the editor binary per sector, which dominates its
// codebook build time; ref: generate_rx_codebook_16ant_random.py:44-92).
int tbrd_set_all(const char* path, const uint8_t* amp, const uint8_t* phase,
                 int n_sectors, int n_ant) {
  Header hdr;
  std::vector<uint8_t> payload;
  int rc = load(path, &hdr, &payload);
  if (rc != kOk) return rc;
  if (uint32_t(n_sectors) != hdr.n_sectors || uint32_t(n_ant) != hdr.n_ant)
    return kErrRange;
  for (int s = 0; s < n_sectors; ++s) {
    uint8_t* dst = payload.data() + size_t(s) * n_ant * 2;
    std::memcpy(dst, amp + size_t(s) * n_ant, n_ant);
    std::memcpy(dst + n_ant, phase + size_t(s) * n_ant, n_ant);
  }
  return store(path, hdr, payload);
}

int tbrd_get_all(const char* path, uint8_t* amp, uint8_t* phase,
                 int n_sectors, int n_ant) {
  Header hdr;
  std::vector<uint8_t> payload;
  int rc = load(path, &hdr, &payload);
  if (rc != kOk) return rc;
  if (uint32_t(n_sectors) != hdr.n_sectors || uint32_t(n_ant) != hdr.n_ant)
    return kErrRange;
  for (int s = 0; s < n_sectors; ++s) {
    const uint8_t* src = payload.data() + size_t(s) * n_ant * 2;
    std::memcpy(amp + size_t(s) * n_ant, src, n_ant);
    std::memcpy(phase + size_t(s) * n_ant, src + n_ant, n_ant);
  }
  return kOk;
}

// Set the active sector count (the `-set_beam_num` role,
// codebook_library.py:33-38).
int tbrd_set_beam_num(const char* path, int n) {
  Header hdr;
  std::vector<uint8_t> payload;
  int rc = load(path, &hdr, &payload);
  if (rc != kOk) return rc;
  if (n < 0 || uint32_t(n) > hdr.n_sectors) return kErrRange;
  hdr.active_sectors = uint32_t(n);
  return store(path, hdr, payload);
}

// Enable/disable RF modules (the `-enable_modules` role,
// codebook_library.py:41-48: the 32-antenna URA is 4 modules of 8).
int tbrd_set_module_mask(const char* path, uint32_t mask) {
  Header hdr;
  std::vector<uint8_t> payload;
  int rc = load(path, &hdr, &payload);
  if (rc != kOk) return rc;
  hdr.module_mask = mask;
  return store(path, hdr, payload);
}

}  // extern "C"
