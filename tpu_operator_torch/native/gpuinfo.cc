// gpuinfo: native device probe of an NVIDIA node (port of native/tpuinfo.cc).
//
// Enumerates what the kernel exposes about the node's cards and reports it
// as JSON over a C ABI, so the node agents (discovery, feature discovery,
// the device plugin, the health monitor, the node-status exporter) get a
// card inventory that does not depend on a working CUDA runtime:
//
//   <dev_dir>/nvidia<N>                  one character device per card, N its
//                                        device minor (nvidiactl, nvidia-uvm,
//                                        nvidia-modeset... are not cards)
//   <driver_dir>/version                 the kernel module's version line
//   <driver_dir>/gpus/<bus>/information  per card: Model, GPU UUID, Bus
//                                        Location, Device Minor
//
// Which nodes this process may open, and what the driver's libraries add,
// the Python wrapper decides (tpu_operator_torch/native/gpuinfo.py), which
// also holds a Python scan of the same paths that must give the same report.

#include <algorithm>
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dirent.h>
#include <string>
#include <vector>

namespace {

struct Node {
  std::string path;
  long long minor;
};

struct Gpu {
  std::string bus_id, model, uuid;
  long long minor = -1;
};

bool all_digits(const std::string& s) {
  if (s.empty()) return false;
  for (char c : s) {
    if (!std::isdigit(static_cast<unsigned char>(c))) return false;
  }
  return true;
}

std::string trim(const std::string& s) {
  size_t b = 0, e = s.size();
  while (b < e && std::isspace(static_cast<unsigned char>(s[b]))) ++b;
  while (e > b && std::isspace(static_cast<unsigned char>(s[e - 1]))) --e;
  return s.substr(b, e - b);
}

// Entry names of a directory (no "." or ".."); false when it cannot be read.
bool list_dir(const std::string& path, std::vector<std::string>* out) {
  DIR* dir = ::opendir(path.c_str());
  if (dir == nullptr) return false;
  while (dirent* entry = ::readdir(dir)) {
    if (std::strcmp(entry->d_name, ".") != 0 && std::strcmp(entry->d_name, "..") != 0) {
      out->push_back(entry->d_name);
    }
  }
  ::closedir(dir);
  return true;
}

bool read_file(const std::string& path, std::string* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (f == nullptr) return false;
  char chunk[4096];
  size_t n;
  while ((n = std::fread(chunk, 1, sizeof chunk, f)) > 0) out->append(chunk, n);
  std::fclose(f);
  return true;
}

// "NVRM version: NVIDIA UNIX x86_64 Kernel Module  550.54.15  ..." -> the
// first whitespace-separated token of the first line made of digits and
// dots, with at least one dot; "" when there is none.
std::string driver_version(const std::string& version_file) {
  std::string text;
  if (!read_file(version_file, &text)) return "";
  std::string line = text.substr(0, text.find('\n'));
  size_t i = 0;
  while (i < line.size()) {
    while (i < line.size() && std::isspace(static_cast<unsigned char>(line[i]))) ++i;
    size_t j = i;
    while (j < line.size() && !std::isspace(static_cast<unsigned char>(line[j]))) ++j;
    std::string token = line.substr(i, j - i);
    bool ok = !token.empty() && std::isdigit(static_cast<unsigned char>(token[0])) &&
              std::isdigit(static_cast<unsigned char>(token.back()));
    bool dot = false;
    for (size_t k = 0; ok && k < token.size(); ++k) {
      if (token[k] == '.') {
        if (token[k - 1] == '.') ok = false;
        dot = true;
      } else if (!std::isdigit(static_cast<unsigned char>(token[k]))) {
        ok = false;
      }
    }
    if (ok && dot) return token;
    i = j;
  }
  return "";
}

Gpu read_information(const std::string& dir, const std::string& bus) {
  Gpu gpu;
  gpu.bus_id = bus;
  std::string text;
  if (!read_file(dir + "/" + bus + "/information", &text)) return gpu;
  size_t start = 0;
  while (start < text.size()) {
    size_t end = text.find('\n', start);
    if (end == std::string::npos) end = text.size();
    std::string line = text.substr(start, end - start);
    start = end + 1;
    size_t colon = line.find(':');
    if (colon == std::string::npos) continue;
    std::string key = trim(line.substr(0, colon)), value = trim(line.substr(colon + 1));
    if (key == "Model") {
      gpu.model = value;
    } else if (key == "GPU UUID") {
      gpu.uuid = value;
    } else if (key == "Bus Location" && !value.empty()) {
      gpu.bus_id = value;
    } else if (key == "Device Minor") {
      gpu.minor = all_digits(value) && value.size() < 12 ? std::atoll(value.c_str()) : -1;
    }
  }
  return gpu;
}

std::string quote(const std::string& s) {
  std::string out = "\"";
  for (unsigned char c : s) {
    if (c == '"' || c == '\\') {
      out += '\\';
      out += static_cast<char>(c);
    } else if (c < 0x20) {
      char esc[8];
      std::snprintf(esc, sizeof esc, "\\u%04x", c);
      out += esc;
    } else {
      out += static_cast<char>(c);
    }
  }
  return out + "\"";
}

int emit(const std::string& json, char* buf, int len) {
  if (static_cast<int>(json.size()) + 1 > len) return -1;
  std::memcpy(buf, json.c_str(), json.size() + 1);
  return static_cast<int>(json.size());
}

}  // namespace

extern "C" {

// Writes {"nodes": [{"path", "minor"}], "driver_version": "...",
// "gpus": [{"bus_id", "minor", "model", "uuid"}]} into buf (NUL-terminated):
// the card nodes of dev_dir by minor, the driver version from
// driver_dir/version, and one entry per directory of driver_dir/gpus by name
// (minor -1 where the information file gives none). Returns the bytes
// written, -1 if buf is too small, -2 if dev_dir cannot be read.
int gpuinfo_scan(const char* dev_dir, const char* driver_dir, char* buf, int len) {
  std::vector<std::string> names;
  if (!list_dir(dev_dir, &names)) return -2;
  std::vector<Node> nodes;
  for (const std::string& name : names) {
    std::string digits = name.substr(0, 6) == "nvidia" ? name.substr(6) : "";
    if (all_digits(digits) && digits.size() < 12) {
      nodes.push_back({std::string(dev_dir) + "/" + name, std::atoll(digits.c_str())});
    }
  }
  std::sort(nodes.begin(), nodes.end(), [](const Node& a, const Node& b) {
    return a.minor != b.minor ? a.minor < b.minor : a.path < b.path;
  });

  const std::string gpus_dir = std::string(driver_dir) + "/gpus";
  std::vector<std::string> buses;
  list_dir(gpus_dir, &buses);  // absent: no per-card information
  std::sort(buses.begin(), buses.end());

  std::string json = "{\"nodes\":[";
  for (size_t i = 0; i < nodes.size(); ++i) {
    if (i) json += ",";
    json += "{\"path\":" + quote(nodes[i].path) + ",\"minor\":" + std::to_string(nodes[i].minor) + "}";
  }
  json += "],\"driver_version\":" + quote(driver_version(std::string(driver_dir) + "/version")) +
          ",\"gpus\":[";
  for (size_t i = 0; i < buses.size(); ++i) {
    Gpu gpu = read_information(gpus_dir, buses[i]);
    if (i) json += ",";
    json += "{\"bus_id\":" + quote(gpu.bus_id) + ",\"minor\":" + std::to_string(gpu.minor) +
            ",\"model\":" + quote(gpu.model) + ",\"uuid\":" + quote(gpu.uuid) + "}";
  }
  json += "]}";
  return emit(json, buf, len);
}

// Per-card (x,y,z) coordinates within this host's block, the reference's
// contract (native/tpuinfo.cc:tpuinfo_chip_coords): bounds from
// TPU_CHIPS_PER_HOST_BOUNDS="x,y,z" (strict, each in 1..64, product at most
// 4096), else by card count (8 -> 2,4,1; 4 -> 2,2,1; 2 -> 2,1,1; n -> n,1,1);
// index walks x fastest. The caller passes the count (the wrapper probes it).
// Writes {"bounds":[x,y,z],"coords":[[x,y,z],...]}; returns bytes written,
// or -1 if buf is too small.
int gpuinfo_chip_coords(int chip_count, char* buf, int len) {
  int bx = 0, by = 0, bz = 0;
  const char* env = std::getenv("TPU_CHIPS_PER_HOST_BOUNDS");
  if (env != nullptr) {
    char trailing = 0;
    if (std::sscanf(env, "%d,%d,%d%c", &bx, &by, &bz, &trailing) != 3) bx = by = bz = 0;
  }
  if (bx <= 0 || by <= 0 || bz <= 0 || bx > 64 || by > 64 || bz > 64 || bx * by * bz > 4096) {
    bx = by = bz = 0;
  }
  if (bx <= 0) {
    switch (chip_count) {
      case 8: bx = 2; by = 4; bz = 1; break;
      case 4: bx = 2; by = 2; bz = 1; break;
      case 2: bx = 2; by = 1; bz = 1; break;
      default: bx = chip_count > 0 ? chip_count : 1; by = 1; bz = 1; break;
    }
  }
  std::string json = "{\"bounds\":[" + std::to_string(bx) + "," + std::to_string(by) + "," +
                     std::to_string(bz) + "],\"coords\":[";
  int n = bx * by * bz;
  for (int i = 0; i < n; ++i) {
    if (i) json += ",";
    json += "[" + std::to_string(i % bx) + "," + std::to_string((i / bx) % by) + "," +
            std::to_string(i / (bx * by)) + "]";
  }
  json += "]}";
  return emit(json, buf, len);
}

// FNV-1a 64-bit content hash (the reference's tpuinfo_fnv64; the wrapper's
// Python fallback uses the same constants).
unsigned long long gpuinfo_fnv64(const char* data, unsigned long long len) {
  unsigned long long h = 0xCBF29CE484222325ULL;
  for (unsigned long long i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 0x100000001B3ULL;
  }
  return h;
}

}  // extern "C"
