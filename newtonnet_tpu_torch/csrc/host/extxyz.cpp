// Fast extended-XYZ parser, the production ingestion path for large
// datasets (millions of frames).
//
// The Python reader (newtonnet_tpu_torch/data/xyz.py) parses the files
// that carry stress=/virial= labels, which this parser does not decode
// (data/loader.py: parse_xyz routes them there).
//
// Supported dialect (the one the NewtonNet datasets use): per frame
//   line 1: n_atoms
//   line 2: key=value pairs; Properties=species:S:1:pos:R:3[:forces:R:3...],
//           optional Lattice="9 floats", energy=..., pbc="T/F T/F T/F"
//   lines 3..: symbol x y z [fx fy fz]
//
// C ABI loaded with ctypes by newtonnet_tpu_torch/data/xyz.py
// (parse_extxyz), built by g++ at first use
// (newtonnet_tpu_torch/ops/_build.py: load_host).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ParsedData {
  std::vector<int32_t> z;        // total_atoms
  std::vector<double> pos;       // total_atoms * 3
  std::vector<double> forces;    // total_atoms * 3 (zeros when absent)
  std::vector<double> cell;      // n_frames * 9
  std::vector<double> energy;    // n_frames (NaN when absent)
  std::vector<uint8_t> pbc;      // n_frames * 3
  std::vector<int64_t> ptr;      // n_frames + 1
  uint8_t has_energy = 0;
  uint8_t has_forces = 0;
  std::string error;
};

const std::unordered_map<std::string, int32_t>& symbol_table() {
  static const char* syms[] = {
      "X",  "H",  "He", "Li", "Be", "B",  "C",  "N",  "O",  "F",  "Ne", "Na",
      "Mg", "Al", "Si", "P",  "S",  "Cl", "Ar", "K",  "Ca", "Sc", "Ti", "V",
      "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br",
      "Kr", "Rb", "Sr", "Y",  "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag",
      "Cd", "In", "Sn", "Sb", "Te", "I",  "Xe", "Cs", "Ba", "La", "Ce", "Pr",
      "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu",
      "Hf", "Ta", "W",  "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi",
      "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U",  "Np", "Pu", "Am",
      "Cm", "Bk", "Cf", "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh",
      "Hs", "Mt", "Ds", "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og"};
  static std::unordered_map<std::string, int32_t> table = [] {
    std::unordered_map<std::string, int32_t> t;
    for (int32_t i = 0; i < (int32_t)(sizeof(syms) / sizeof(*syms)); ++i)
      t[syms[i]] = i;
    return t;
  }();
  return table;
}

// Extract key=value (value possibly quoted) pairs from the comment line.
void parse_comment(const char* line, const char* end,
                   std::unordered_map<std::string, std::string>* out) {
  const char* p = line;
  while (p < end) {
    while (p < end && std::isspace((unsigned char)*p)) ++p;
    const char* key_start = p;
    while (p < end && *p != '=' && !std::isspace((unsigned char)*p)) ++p;
    if (p >= end || *p != '=') continue;
    std::string key(key_start, p - key_start);
    ++p;  // skip '='
    std::string value;
    if (p < end && *p == '"') {
      ++p;
      const char* v = p;
      while (p < end && *p != '"') ++p;
      value.assign(v, p - v);
      if (p < end) ++p;
    } else {
      const char* v = p;
      while (p < end && !std::isspace((unsigned char)*p)) ++p;
      value.assign(v, p - v);
    }
    (*out)[std::move(key)] = std::move(value);
  }
}

struct PropField {
  std::string name;
  char kind;
  int ncols;
};

std::vector<PropField> parse_properties(const std::string& spec) {
  std::vector<PropField> fields;
  size_t start = 0;
  std::vector<std::string> parts;
  while (start <= spec.size()) {
    size_t colon = spec.find(':', start);
    if (colon == std::string::npos) colon = spec.size();
    parts.emplace_back(spec.substr(start, colon - start));
    start = colon + 1;
  }
  for (size_t i = 0; i + 2 < parts.size(); i += 3) {
    fields.push_back({parts[i], parts[i + 1].empty() ? 'R' : parts[i + 1][0],
                      std::atoi(parts[i + 2].c_str())});
  }
  return fields;
}

}  // namespace

extern "C" {

void* xyz_parse(const char* path) {
  auto* d = new ParsedData();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    d->error = "cannot open file";
    return d;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (std::fread(buf.data(), 1, size, f) != (size_t)size) {
    d->error = "read failed";
    std::fclose(f);
    return d;
  }
  std::fclose(f);
  buf[size] = '\0';

  d->ptr.push_back(0);
  const char* p = buf.data();
  const char* bend = buf.data() + size;

  auto next_line = [&](const char** line_end) -> const char* {
    if (p >= bend) return nullptr;
    const char* start = p;
    const char* nl = (const char*)memchr(p, '\n', bend - p);
    if (!nl) nl = bend;
    *line_end = nl;
    p = nl < bend ? nl + 1 : bend;
    return start;
  };

  const auto& symtab = symbol_table();
  while (true) {
    const char* le;
    const char* line = next_line(&le);
    if (!line) break;
    // skip blank lines between frames
    const char* q = line;
    while (q < le && std::isspace((unsigned char)*q)) ++q;
    if (q == le) continue;

    char* endp;
    long n = std::strtol(line, &endp, 10);
    if (n <= 0) {
      d->error = "bad atom count";
      break;
    }

    const char* ce;
    const char* comment = next_line(&ce);
    if (!comment) {
      d->error = "truncated frame";
      break;
    }
    std::unordered_map<std::string, std::string> info;
    parse_comment(comment, ce, &info);

    auto props_it = info.find("Properties");
    std::vector<PropField> fields =
        parse_properties(props_it != info.end() ? props_it->second
                                                : "species:S:1:pos:R:3");

    double cell[9] = {0};
    uint8_t pbc[3] = {0, 0, 0};
    auto lat_it = info.find("Lattice");
    if (lat_it != info.end()) {
      const char* s = lat_it->second.c_str();
      char* e2;
      for (int i = 0; i < 9; ++i) {
        cell[i] = std::strtod(s, &e2);
        s = e2;
      }
      pbc[0] = pbc[1] = pbc[2] = 1;
    }
    auto pbc_it = info.find("pbc");
    if (pbc_it != info.end()) {
      int axis = 0;
      for (const char* s = pbc_it->second.c_str(); *s && axis < 3; ++s) {
        if (*s == 'T' || *s == '1')
          pbc[axis++] = 1;
        else if (*s == 'F' || *s == '0')
          pbc[axis++] = 0;
      }
    }
    double energy = std::nan("");
    auto e_it = info.find("energy");
    if (e_it != info.end()) {
      energy = std::strtod(e_it->second.c_str(), nullptr);
      d->has_energy = 1;
    }

    size_t base = d->z.size();
    d->z.resize(base + n);
    d->pos.resize((base + n) * 3, 0.0);
    d->forces.resize((base + n) * 3, 0.0);

    for (long i = 0; i < n; ++i) {
      const char* ale;
      const char* aline = next_line(&ale);
      if (!aline) {
        d->error = "truncated atom block";
        break;
      }
      const char* s = aline;
      for (const auto& fld : fields) {
        if (fld.kind == 'S') {
          while (s < ale && std::isspace((unsigned char)*s)) ++s;
          const char* ws = s;
          while (s < ale && !std::isspace((unsigned char)*s)) ++s;
          if (fld.name == "species") {
            auto it = symtab.find(std::string(ws, s - ws));
            d->z[base + i] = it != symtab.end() ? it->second : 0;
          }
        } else {
          for (int c = 0; c < fld.ncols; ++c) {
            char* e2;
            double v = std::strtod(s, &e2);
            s = e2;
            if (fld.name == "pos")
              d->pos[(base + i) * 3 + c] = v;
            else if (fld.name == "forces" || fld.name == "force") {
              d->forces[(base + i) * 3 + c] = v;
              d->has_forces = 1;
            } else if (fld.kind == 'I' && fld.name == "Z") {
              d->z[base + i] = (int32_t)v;
            }
          }
        }
      }
    }
    if (!d->error.empty()) break;

    for (int i = 0; i < 9; ++i) d->cell.push_back(cell[i]);
    for (int i = 0; i < 3; ++i) d->pbc.push_back(pbc[i]);
    d->energy.push_back(energy);
    d->ptr.push_back((int64_t)(base + n));
  }
  return d;
}

const char* xyz_error(void* h) {
  auto* d = (ParsedData*)h;
  return d->error.empty() ? nullptr : d->error.c_str();
}

int64_t xyz_n_frames(void* h) { return ((ParsedData*)h)->energy.size(); }
int64_t xyz_total_atoms(void* h) { return ((ParsedData*)h)->z.size(); }
uint8_t xyz_has_energy(void* h) { return ((ParsedData*)h)->has_energy; }
uint8_t xyz_has_forces(void* h) { return ((ParsedData*)h)->has_forces; }

void xyz_fill(void* h, int32_t* z, double* pos, double* forces, double* cell,
              double* energy, uint8_t* pbc, int64_t* ptr) {
  auto* d = (ParsedData*)h;
  std::memcpy(z, d->z.data(), d->z.size() * sizeof(int32_t));
  std::memcpy(pos, d->pos.data(), d->pos.size() * sizeof(double));
  std::memcpy(forces, d->forces.data(), d->forces.size() * sizeof(double));
  std::memcpy(cell, d->cell.data(), d->cell.size() * sizeof(double));
  std::memcpy(energy, d->energy.data(), d->energy.size() * sizeof(double));
  std::memcpy(pbc, d->pbc.data(), d->pbc.size() * sizeof(uint8_t));
  std::memcpy(ptr, d->ptr.data(), d->ptr.size() * sizeof(int64_t));
}

void xyz_free(void* h) { delete (ParsedData*)h; }

}  // extern "C"
