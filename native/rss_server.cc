// rss_server: native measurement server for the 2ACE testbed stack.
//
// Replaces the closed-source `wil6210_server-2.2.0` RSS-dump firmware server
// the reference launches over SSH (ref: firmware/load_csi_firmware.sh:12) and
// speaks the same logical protocol as main/codebook_library.py:453-516
// (fetch_rss): newline-delimited JSON over TCP, command "per_beam_snr"
// returning an array of per-beam raw RSSI words.
//
// The server owns the measurement state (ground-truth channel + active
// codebook rows, both settable over the wire) and synthesizes RSSI words
// through the same chain the hardware produces:
//   power_dBm = 10*log10(|rows * h|^2)   ->   rssi = (dBm + 74.3875)/0.0652
// (inverse of the QCA6320 calibration, ref: main/main.py:113), integer
// quantized with optional Gaussian dump noise.
//
// Protocol (one JSON object per line):
//   {"cmd":"set_channel","re":[...],"im":[...]}            -> {"ok":true}
//   {"cmd":"set_beams","re":[[...],...],"im":[[...],...]}  -> {"ok":true}
//   {"cmd":"set_noise","std_db":0.5,"seed":7}              -> {"ok":true}
//   {"cmd":"per_beam_snr"}              -> {"snr":[[w...] x n_dumps]}
//   {"cmd":"quit"}                      -> {"ok":true} and closes
//
// Build: g++ -O2 -std=c++17 -o rss_server rss_server.cc -lpthread
// Usage: rss_server <port> [n_dumps]

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cctype>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <vector>

namespace {

using cplx = std::complex<double>;

struct State {
  std::vector<cplx> h;                 // ground-truth vec(H)
  std::vector<std::vector<cplx>> rows; // active codebook rows
  double noise_std_db = 0.0;
  int n_dumps = 10;                    // dumps per request (ref :474)
  std::mt19937 rng{12345};
};

// ---------------------------------------------------------------- tiny JSON
// Purpose-built scanner for this protocol's restricted JSON (flat objects,
// numeric arrays / arrays-of-arrays). Not a general parser.

const char* skip_ws(const char* p) {
  while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
  return p;
}

// find  "key"  and return pointer just past the following ':' (or nullptr)
const char* find_key(const std::string& s, const std::string& key) {
  std::string pat = "\"" + key + "\"";
  size_t at = s.find(pat);
  if (at == std::string::npos) return nullptr;
  const char* p = s.c_str() + at + pat.size();
  p = skip_ws(p);
  if (*p != ':') return nullptr;
  return skip_ws(p + 1);
}

bool parse_number_array(const char* p, std::vector<double>* out) {
  p = skip_ws(p);
  if (*p != '[') return false;
  ++p;
  while (true) {
    p = skip_ws(p);
    if (*p == ']') return true;
    char* end = nullptr;
    double v = std::strtod(p, &end);
    if (end == p) return false;
    out->push_back(v);
    p = skip_ws(end);
    if (*p == ',') ++p;
  }
}

bool parse_matrix(const char* p, std::vector<std::vector<double>>* out) {
  p = skip_ws(p);
  if (*p != '[') return false;
  ++p;
  while (true) {
    p = skip_ws(p);
    if (*p == ']') return true;
    if (*p != '[') return false;
    std::vector<double> row;
    // find matching close bracket for this row
    const char* q = p;
    if (!parse_number_array(q, &row)) return false;
    out->push_back(std::move(row));
    int depth = 0;
    while (*p) {
      if (*p == '[') ++depth;
      else if (*p == ']') { --depth; if (depth == 0) { ++p; break; } }
      ++p;
    }
    p = skip_ws(p);
    if (*p == ',') ++p;
  }
}

double parse_number(const char* p, double fallback) {
  char* end = nullptr;
  double v = std::strtod(p, &end);
  return end == p ? fallback : v;
}

// ------------------------------------------------------------- measurement

std::vector<std::vector<int>> per_beam_rssi(State* st) {
  const double kSlope = 0.0652, kOffset = -74.3875;  // ref: main.py:113
  size_t m = st->rows.size();
  std::vector<double> dbm(m, -100.0);
  for (size_t i = 0; i < m; ++i) {
    cplx acc = 0.0;
    size_t n = std::min(st->rows[i].size(), st->h.size());
    for (size_t k = 0; k < n; ++k) acc += st->rows[i][k] * st->h[k];
    double p = std::norm(acc);
    dbm[i] = 10.0 * std::log10(p > 1e-30 ? p : 1e-30);
  }
  std::normal_distribution<double> noise(0.0, st->noise_std_db);
  std::vector<std::vector<int>> dumps(st->n_dumps, std::vector<int>(m));
  for (int d = 0; d < st->n_dumps; ++d) {
    for (size_t i = 0; i < m; ++i) {
      double val = dbm[i];
      if (st->noise_std_db > 0.0) val += noise(st->rng);
      double w = (val - kOffset) / kSlope;    // inverse calibration
      if (w < 0) w = 0;
      if (w > 1000) w = 1000;
      dumps[d][i] = static_cast<int>(std::lround(w));
    }
  }
  return dumps;
}

bool read_line(int fd, std::string* line) {
  line->clear();
  char c;
  while (true) {
    ssize_t r = ::recv(fd, &c, 1, 0);
    if (r <= 0) return false;
    if (c == '\n') return true;
    line->push_back(c);
    if (line->size() > (64u << 20)) return false;   // 64 MB guard
  }
}

bool write_all(int fd, const std::string& s) {
  size_t off = 0;
  while (off < s.size()) {
    ssize_t w = ::send(fd, s.data() + off, s.size() - off, 0);
    if (w <= 0) return false;
    off += static_cast<size_t>(w);
  }
  return true;
}

void to_complex(const std::vector<double>& re, const std::vector<double>& im,
                std::vector<cplx>* out) {
  out->resize(re.size());
  for (size_t i = 0; i < re.size(); ++i)
    (*out)[i] = cplx(re[i], i < im.size() ? im[i] : 0.0);
}

bool handle(int fd, State* st, const std::string& line) {
  if (line.find("\"per_beam_snr\"") != std::string::npos) {
    auto dumps = per_beam_rssi(st);
    std::string out = "{\"snr\":[";
    for (size_t d = 0; d < dumps.size(); ++d) {
      out += d ? ",[" : "[";
      for (size_t i = 0; i < dumps[d].size(); ++i) {
        if (i) out += ",";
        out += std::to_string(dumps[d][i]);
      }
      out += "]";
    }
    out += "]}\n";
    return write_all(fd, out);
  }
  if (line.find("\"set_channel\"") != std::string::npos) {
    std::vector<double> re, im;
    const char* pr = find_key(line, "re");
    const char* pi = find_key(line, "im");
    if (!pr || !parse_number_array(pr, &re)) return write_all(fd, "{\"ok\":false}\n");
    if (pi) parse_number_array(pi, &im);
    to_complex(re, im, &st->h);
    return write_all(fd, "{\"ok\":true}\n");
  }
  if (line.find("\"set_beams\"") != std::string::npos) {
    std::vector<std::vector<double>> re, im;
    const char* pr = find_key(line, "re");
    const char* pi = find_key(line, "im");
    if (!pr || !parse_matrix(pr, &re)) return write_all(fd, "{\"ok\":false}\n");
    if (pi) parse_matrix(pi, &im);
    st->rows.assign(re.size(), {});
    for (size_t i = 0; i < re.size(); ++i) {
      const std::vector<double>& imr =
          i < im.size() ? im[i] : std::vector<double>();
      to_complex(re[i], imr, &st->rows[i]);
    }
    return write_all(fd, "{\"ok\":true}\n");
  }
  if (line.find("\"set_noise\"") != std::string::npos) {
    const char* ps = find_key(line, "std_db");
    const char* pd = find_key(line, "seed");
    if (ps) st->noise_std_db = parse_number(ps, st->noise_std_db);
    if (pd) st->rng.seed(static_cast<uint32_t>(parse_number(pd, 12345)));
    return write_all(fd, "{\"ok\":true}\n");
  }
  if (line.find("\"quit\"") != std::string::npos) {
    write_all(fd, "{\"ok\":true}\n");
    return false;
  }
  return write_all(fd, "{\"error\":\"unknown cmd\"}\n");
}

}  // namespace

int main(int argc, char** argv) {
  int port = argc > 1 ? std::atoi(argv[1]) : 10002;  // fw default port
  State st;
  if (argc > 2) st.n_dumps = std::atoi(argv[2]);

  int srv = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  ::setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    std::perror("bind");
    return 1;
  }
  ::listen(srv, 4);
  std::fprintf(stderr, "rss_server listening on 127.0.0.1:%d\n", port);
  std::fflush(stderr);

  while (true) {
    int fd = ::accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    std::string line;
    while (read_line(fd, &line)) {
      if (!handle(fd, &st, line)) { ::close(fd); fd = -1; break; }
    }
    if (fd >= 0) ::close(fd);
  }
}
