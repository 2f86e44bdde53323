// Native codec for SCS's binary problem format, plus dense<->CSC
// conversion used by the host-side IO path: scs_tpu_torch's own copy of
// the JAX package's native/scs_io.cc, with one entry point more
// (scs_file_get_csc, the stored CSC arrays for the sparse reader).
//
// Format definition: SCS's src/rw.c:574-684 (header + cone + data +
// settings) and :459-572 (the "SCSE" magic-tagged extension block
// carrying complex-PSD and spectral cones). The file is memory-loaded once
// and parsed with a cursor; integers are width-cast per the file header
// (DLONG migration, rw.c:60-118).
//
// Exposed as a C ABI consumed via ctypes from scs_tpu_torch.utils.native,
// which builds it with g++ at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kExtMagic = 0x53435345;  // "SCSE"
constexpr uint32_t kExtVersion = 1;
constexpr const char* kScsVersion = "3.2.11";

struct Parsed {
  // cone
  int64_t z = 0, l = 0, bsize = 0, ep = 0, ed = 0;
  std::vector<double> bl, bu, p;
  std::vector<int64_t> q, s;
  // extension cones
  std::vector<int64_t> cs, d, nuc_m, nuc_n, ell1, sl_n, sl_k;
  // data
  int64_t m = 0, n = 0, has_p = 0;
  std::vector<double> b, c;
  std::vector<int64_t> a_colptr, a_rowidx, p_colptr, p_rowidx;
  std::vector<double> a_vals, p_vals;
  // settings
  int64_t normalize = 1, max_iters = 100000, verbose = 0, warm_start = 0;
  int64_t accel_lookback = 10, accel_interval = 10, accel_type1 = 1;
  int64_t adaptive_scale = 1, legacy = 0;
  double scale = 0.1, rho_x = 1e-6, eps_abs = 1e-4, eps_rel = 1e-4;
  double eps_infeas = 1e-7, alpha = 1.5, accel_reg = 1e-8, accel_relax = 1.0;
  double time_limit = 0.0;
};

class Cursor {
 public:
  Cursor(const uint8_t* buf, size_t len, int int_sz)
      : buf_(buf), len_(len), int_sz_(int_sz) {}

  bool raw(void* out, size_t nbytes) {
    if (off_ + nbytes > len_) return false;
    std::memcpy(out, buf_ + off_, nbytes);
    off_ += nbytes;
    return true;
  }

  bool u32(uint32_t* out) { return raw(out, 4); }

  // Remaining-bytes guard: counts come from untrusted file content, so a
  // resize must never be attempted unless the payload actually fits.
  bool fits(int64_t count, size_t elem_size) const {
    return count >= 0 &&
           static_cast<uint64_t>(count) <= (len_ - off_) / elem_size;
  }

  bool ints(int64_t* out, size_t count) {
    if (int_sz_ == 8) return raw(out, count * 8);
    std::vector<int32_t> tmp(count);
    if (!raw(tmp.data(), count * 4)) return false;
    for (size_t i = 0; i < count; ++i) out[i] = tmp[i];
    return true;
  }

  bool ivec(std::vector<int64_t>* out, int64_t count) {
    if (!fits(count, static_cast<size_t>(int_sz_))) return false;
    out->resize(static_cast<size_t>(count));
    return ints(out->data(), static_cast<size_t>(count));
  }

  bool int1(int64_t* out) { return ints(out, 1); }

  bool fvec(std::vector<double>* out, int64_t count) {
    if (!fits(count, 8)) return false;
    out->resize(static_cast<size_t>(count));
    return raw(out->data(), static_cast<size_t>(count) * 8);
  }

  bool f1(double* out) { return raw(out, 8); }

  bool eof() const { return off_ >= len_; }

 private:
  const uint8_t* buf_;
  size_t len_;
  size_t off_ = 0;
  int int_sz_;
};

bool read_amatrix(Cursor* c, int64_t* m, int64_t* n,
                  std::vector<int64_t>* colptr, std::vector<int64_t>* rowidx,
                  std::vector<double>* vals) {
  if (!c->int1(m) || !c->int1(n)) return false;
  if (*m < 0 || *n < 0) return false;
  if (!c->ivec(colptr, *n + 1)) return false;
  const int64_t nnz = colptr->empty() ? 0 : colptr->back();
  if (nnz < 0) return false;
  if (!c->fvec(vals, nnz)) return false;
  return c->ivec(rowidx, nnz);
}

// Full structural validation of parsed CSC arrays. The file is untrusted
// input (interchange files from the reference solver, run_from_file CLI),
// so every colptr entry and rowidx must be range-checked BEFORE the
// densify loops index with them (mirrors SCS(validate_lin_sys),
// linsys/scs_matrix.c:65-157).
bool valid_csc(int64_t m, int64_t n, const std::vector<int64_t>& colptr,
               const std::vector<int64_t>& rowidx,
               const std::vector<double>& vals) {
  if (m < 0 || n < 0) return false;
  if (colptr.size() != static_cast<size_t>(n) + 1) return false;
  if (colptr[0] != 0) return false;
  for (int64_t j = 0; j < n; ++j) {
    if (colptr[j + 1] < colptr[j]) return false;
  }
  const int64_t nnz = colptr[n];
  if (nnz != static_cast<int64_t>(vals.size()) ||
      nnz != static_cast<int64_t>(rowidx.size()))
    return false;
  for (int64_t k = 0; k < nnz; ++k) {
    if (rowidx[k] < 0 || rowidx[k] >= m) return false;
  }
  return true;
}

void set_err(char* err, int64_t errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// Scalar fields + array lengths, mirrored by ctypes.Structure in Python.
struct ScsFileMeta {
  int64_t z, l, bsize, qsize, ssize, ep, ed, psize;
  int64_t cssize, dsize, nucsize, ell1size, slsize;
  int64_t m, n, has_p, a_nnz, p_nnz;
  int64_t normalize, max_iters, verbose, warm_start;
  int64_t accel_lookback, accel_interval, accel_type1, adaptive_scale;
  int64_t legacy;
  double scale, rho_x, eps_abs, eps_rel, eps_infeas, alpha;
  double accel_reg, accel_relax, time_limit;
};

void* scs_file_open(const char* path, char* err, int64_t errlen) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_err(err, errlen, std::string("cannot open ") + path);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_END);
  long flen = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(flen));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) {
    set_err(err, errlen, "short read");
    return nullptr;
  }
  if (buf.size() < 12) {
    set_err(err, errlen, "file too small for SCS header");
    return nullptr;
  }

  uint32_t int_sz, float_sz, version_sz;
  std::memcpy(&int_sz, buf.data(), 4);
  std::memcpy(&float_sz, buf.data() + 4, 4);
  std::memcpy(&version_sz, buf.data() + 8, 4);
  if (int_sz != 4 && int_sz != 8) {
    set_err(err, errlen, "unsupported integer size");
    return nullptr;
  }
  if (float_sz != 8) {
    set_err(err, errlen, "unsupported float size (need f64)");
    return nullptr;
  }
  if (static_cast<uint64_t>(version_sz) + 12 > buf.size()) {
    set_err(err, errlen, "corrupt version field");
    return nullptr;
  }
  std::string version(reinterpret_cast<const char*>(buf.data() + 12),
                      version_sz);

  auto* p = new Parsed();
  p->legacy = (version != kScsVersion) ? 1 : 0;
  Cursor c(buf.data() + 12 + version_sz, buf.size() - 12 - version_sz,
           static_cast<int>(int_sz));

  bool ok = true;
  // ---- cone (rw.c:261-289) ----
  int64_t qsize = 0, ssize = 0, psize = 0;
  ok = ok && c.int1(&p->z) && c.int1(&p->l) && c.int1(&p->bsize);
  const int64_t box_len = p->bsize > 1 ? p->bsize - 1 : 0;
  ok = ok && c.fvec(&p->bl, box_len) && c.fvec(&p->bu, box_len);
  ok = ok && c.int1(&qsize) && c.ivec(&p->q, qsize);
  ok = ok && c.int1(&ssize) && c.ivec(&p->s, ssize);
  ok = ok && c.int1(&p->ep) && c.int1(&p->ed);
  ok = ok && c.int1(&psize) && c.fvec(&p->p, psize);

  // ---- data (rw.c:424-457) ----
  ok = ok && c.int1(&p->m) && c.int1(&p->n);
  ok = ok && c.fvec(&p->b, p->m);
  ok = ok && c.fvec(&p->c, p->n);
  int64_t am = 0, an = 0;
  ok = ok && read_amatrix(&c, &am, &an, &p->a_colptr, &p->a_rowidx,
                          &p->a_vals);
  if (ok && !(am == p->m && an == p->n &&
              valid_csc(p->m, p->n, p->a_colptr, p->a_rowidx, p->a_vals))) {
    set_err(err, errlen, "corrupt CSC structure for A in SCS data file");
    delete p;
    return nullptr;
  }
  ok = ok && c.int1(&p->has_p);
  if (ok && p->has_p) {
    int64_t pm = 0, pn = 0;
    ok = read_amatrix(&c, &pm, &pn, &p->p_colptr, &p->p_rowidx, &p->p_vals);
    if (ok && !(pm == p->n && pn == p->n &&
                valid_csc(p->n, p->n, p->p_colptr, p->p_rowidx, p->p_vals))) {
      set_err(err, errlen, "corrupt CSC structure for P in SCS data file");
      delete p;
      return nullptr;
    }
  }

  // ---- settings (rw.c:322-355) ----
  ok = ok && c.int1(&p->normalize) && c.f1(&p->scale) && c.f1(&p->rho_x);
  ok = ok && c.int1(&p->max_iters) && c.f1(&p->eps_abs) &&
       c.f1(&p->eps_rel) && c.f1(&p->eps_infeas) && c.f1(&p->alpha);
  ok = ok && c.int1(&p->verbose) && c.int1(&p->warm_start);
  ok = ok && c.int1(&p->accel_lookback) && c.int1(&p->accel_interval);
  if (ok) {
    if (p->legacy) {
      ok = c.int1(&p->adaptive_scale);
    } else {
      ok = c.int1(&p->accel_type1) && c.f1(&p->accel_reg) &&
           c.f1(&p->accel_relax) && c.int1(&p->adaptive_scale);
    }
  }

  // ---- extension block (rw.c:510-572) ----
  if (ok && !c.eof()) {
    uint32_t magic = 0;
    if (c.u32(&magic) && magic == kExtMagic) {
      uint32_t ext_version = 0;
      ok = c.u32(&ext_version);
      if (ok && ext_version != kExtVersion) {
        set_err(err, errlen, "unsupported extension version");
        delete p;
        return nullptr;
      }
      int64_t k = 0;
      ok = ok && c.int1(&k) && c.ivec(&p->cs, k);
      ok = ok && c.int1(&k) && c.ivec(&p->d, k);
      ok = ok && c.int1(&k) && c.ivec(&p->nuc_m, k) &&
           c.ivec(&p->nuc_n, k);
      ok = ok && c.int1(&k) && c.ivec(&p->ell1, k);
      ok = ok && c.int1(&k) && c.ivec(&p->sl_n, k) &&
           c.ivec(&p->sl_k, k);
      ok = ok && c.f1(&p->time_limit);
    }
  }

  if (!ok) {
    set_err(err, errlen, "unexpected end of SCS data file");
    delete p;
    return nullptr;
  }
  return p;
}

void scs_file_meta(void* h, ScsFileMeta* meta) {
  const auto* p = static_cast<Parsed*>(h);
  std::memset(meta, 0, sizeof(*meta));
  meta->z = p->z;
  meta->l = p->l;
  meta->bsize = p->bsize;
  meta->qsize = static_cast<int64_t>(p->q.size());
  meta->ssize = static_cast<int64_t>(p->s.size());
  meta->ep = p->ep;
  meta->ed = p->ed;
  meta->psize = static_cast<int64_t>(p->p.size());
  meta->cssize = static_cast<int64_t>(p->cs.size());
  meta->dsize = static_cast<int64_t>(p->d.size());
  meta->nucsize = static_cast<int64_t>(p->nuc_m.size());
  meta->ell1size = static_cast<int64_t>(p->ell1.size());
  meta->slsize = static_cast<int64_t>(p->sl_n.size());
  meta->m = p->m;
  meta->n = p->n;
  meta->has_p = p->has_p;
  meta->a_nnz = static_cast<int64_t>(p->a_vals.size());
  meta->p_nnz = static_cast<int64_t>(p->p_vals.size());
  meta->normalize = p->normalize;
  meta->max_iters = p->max_iters;
  meta->verbose = p->verbose;
  meta->warm_start = p->warm_start;
  meta->accel_lookback = p->accel_lookback;
  meta->accel_interval = p->accel_interval;
  meta->accel_type1 = p->accel_type1;
  meta->adaptive_scale = p->adaptive_scale;
  meta->legacy = p->legacy;
  meta->scale = p->scale;
  meta->rho_x = p->rho_x;
  meta->eps_abs = p->eps_abs;
  meta->eps_rel = p->eps_rel;
  meta->eps_infeas = p->eps_infeas;
  meta->alpha = p->alpha;
  meta->accel_reg = p->accel_reg;
  meta->accel_relax = p->accel_relax;
  meta->time_limit = p->time_limit;
}

// which: 0=q, 1=s, 2=cs, 3=d, 4=nuc_m, 5=nuc_n, 6=ell1, 7=sl_n, 8=sl_k
int64_t scs_file_get_ints(void* h, int which, int64_t* out) {
  const auto* p = static_cast<Parsed*>(h);
  const std::vector<int64_t>* v = nullptr;
  switch (which) {
    case 0: v = &p->q; break;
    case 1: v = &p->s; break;
    case 2: v = &p->cs; break;
    case 3: v = &p->d; break;
    case 4: v = &p->nuc_m; break;
    case 5: v = &p->nuc_n; break;
    case 6: v = &p->ell1; break;
    case 7: v = &p->sl_n; break;
    case 8: v = &p->sl_k; break;
    default: return -1;
  }
  std::memcpy(out, v->data(), v->size() * 8);
  return static_cast<int64_t>(v->size());
}

// which: 0=b, 1=c, 2=bl, 3=bu, 4=p (power exponents)
int64_t scs_file_get_floats(void* h, int which, double* out) {
  const auto* p = static_cast<Parsed*>(h);
  const std::vector<double>* v = nullptr;
  switch (which) {
    case 0: v = &p->b; break;
    case 1: v = &p->c; break;
    case 2: v = &p->bl; break;
    case 3: v = &p->bu; break;
    case 4: v = &p->p; break;
    default: return -1;
  }
  std::memcpy(out, v->data(), v->size() * 8);
  return static_cast<int64_t>(v->size());
}

// Densify into a row-major (rows, cols) buffer the caller zero-initialized.
// which: 0 = A (m x n); 1 = P (n x n), stored upper-tri -> symmetrized.
int64_t scs_file_get_dense(void* h, int which, double* out) {
  const auto* p = static_cast<Parsed*>(h);
  if (which == 0) {
    const int64_t n = p->n;
    for (int64_t j = 0; j < n; ++j) {
      for (int64_t k = p->a_colptr[j]; k < p->a_colptr[j + 1]; ++k) {
        out[p->a_rowidx[k] * n + j] = p->a_vals[k];
      }
    }
    return p->m * p->n;
  }
  if (which == 1 && p->has_p) {
    const int64_t n = p->n;
    for (int64_t j = 0; j < n; ++j) {
      for (int64_t k = p->p_colptr[j]; k < p->p_colptr[j + 1]; ++k) {
        const int64_t i = p->p_rowidx[k];
        out[i * n + j] = p->p_vals[k];
        out[j * n + i] = p->p_vals[k];
      }
    }
    return n * n;
  }
  return -1;
}

// The stored CSC arrays, never densified: which 0 = A (colptr n + 1,
// rowidx and vals a_nnz), 1 = P (its upper triangle as stored; n + 1 and
// p_nnz). Returns the number of nonzeros, -1 for a P the file lacks.
int64_t scs_file_get_csc(void* h, int which, int64_t* colptr,
                         int64_t* rowidx, double* vals) {
  const auto* p = static_cast<Parsed*>(h);
  const std::vector<int64_t>* cp = nullptr;
  const std::vector<int64_t>* ri = nullptr;
  const std::vector<double>* vv = nullptr;
  if (which == 0) {
    cp = &p->a_colptr;
    ri = &p->a_rowidx;
    vv = &p->a_vals;
  } else if (which == 1 && p->has_p) {
    cp = &p->p_colptr;
    ri = &p->p_rowidx;
    vv = &p->p_vals;
  } else {
    return -1;
  }
  std::memcpy(colptr, cp->data(), cp->size() * 8);
  std::memcpy(rowidx, ri->data(), ri->size() * 8);
  std::memcpy(vals, vv->data(), vv->size() * 8);
  return static_cast<int64_t>(vv->size());
}

void scs_file_close(void* h) { delete static_cast<Parsed*>(h); }

namespace {

void append(std::vector<uint8_t>* out, const void* src, size_t n) {
  const auto* s = static_cast<const uint8_t*>(src);
  out->insert(out->end(), s, s + n);
}

void w_u32(std::vector<uint8_t>* out, uint32_t v) { append(out, &v, 4); }

void w_ints(std::vector<uint8_t>* out, const int64_t* v, size_t n) {
  append(out, v, n * 8);
}

void w_int1(std::vector<uint8_t>* out, int64_t v) { w_ints(out, &v, 1); }

void w_floats(std::vector<uint8_t>* out, const double* v, size_t n) {
  append(out, v, n * 8);
}

void w_f1(std::vector<uint8_t>* out, double v) { w_floats(out, &v, 1); }

// Extract CSC from a row-major dense matrix, dropping zeros; upper_only
// keeps rows <= col (the reference's P storage, scs.h:111-114).
void w_amatrix(std::vector<uint8_t>* out, const double* M, int64_t rows,
               int64_t cols, bool upper_only) {
  std::vector<int64_t> colptr(static_cast<size_t>(cols) + 1, 0);
  std::vector<int64_t> rowidx;
  std::vector<double> vals;
  for (int64_t j = 0; j < cols; ++j) {
    const int64_t rmax = upper_only ? j + 1 : rows;
    for (int64_t i = 0; i < rmax; ++i) {
      const double v = M[i * cols + j];
      if (v != 0.0) {
        rowidx.push_back(i);
        vals.push_back(v);
      }
    }
    colptr[static_cast<size_t>(j) + 1] = static_cast<int64_t>(rowidx.size());
  }
  w_int1(out, rows);
  w_int1(out, cols);
  w_ints(out, colptr.data(), colptr.size());
  w_floats(out, vals.data(), vals.size());
  w_ints(out, rowidx.data(), rowidx.size());
}

}  // namespace

int64_t scs_file_write(
    const char* path, const ScsFileMeta* meta, const double* bl,
    const double* bu, const int64_t* q, const int64_t* s, const double* pw,
    const int64_t* cs, const int64_t* d, const int64_t* nuc_m,
    const int64_t* nuc_n, const int64_t* ell1, const int64_t* sl_n,
    const int64_t* sl_k, const double* b, const double* c,
    const double* A_dense, const double* P_dense, char* err, int64_t errlen) {
  std::vector<uint8_t> out;
  out.reserve(1 << 16);

  w_u32(&out, 8);  // int size (DLONG layout)
  w_u32(&out, 8);  // float size
  const size_t vlen = std::strlen(kScsVersion);
  w_u32(&out, static_cast<uint32_t>(vlen));
  append(&out, kScsVersion, vlen);

  const size_t box_len =
      meta->bsize > 1 ? static_cast<size_t>(meta->bsize - 1) : 0;
  w_int1(&out, meta->z);
  w_int1(&out, meta->l);
  w_int1(&out, meta->bsize);
  w_floats(&out, bl, box_len);
  w_floats(&out, bu, box_len);
  w_int1(&out, meta->qsize);
  w_ints(&out, q, static_cast<size_t>(meta->qsize));
  w_int1(&out, meta->ssize);
  w_ints(&out, s, static_cast<size_t>(meta->ssize));
  w_int1(&out, meta->ep);
  w_int1(&out, meta->ed);
  w_int1(&out, meta->psize);
  w_floats(&out, pw, static_cast<size_t>(meta->psize));

  w_int1(&out, meta->m);
  w_int1(&out, meta->n);
  w_floats(&out, b, static_cast<size_t>(meta->m));
  w_floats(&out, c, static_cast<size_t>(meta->n));
  w_amatrix(&out, A_dense, meta->m, meta->n, false);
  w_int1(&out, meta->has_p);
  if (meta->has_p) {
    w_amatrix(&out, P_dense, meta->n, meta->n, true);
  }

  w_int1(&out, meta->normalize);
  w_f1(&out, meta->scale);
  w_f1(&out, meta->rho_x);
  w_int1(&out, meta->max_iters);
  w_f1(&out, meta->eps_abs);
  w_f1(&out, meta->eps_rel);
  w_f1(&out, meta->eps_infeas);
  w_f1(&out, meta->alpha);
  w_int1(&out, meta->verbose);
  w_int1(&out, 0);  // warm_start always written as 0 (rw.c:293)
  w_int1(&out, meta->accel_lookback);
  w_int1(&out, meta->accel_interval);
  w_int1(&out, meta->accel_type1);
  w_f1(&out, meta->accel_reg);
  w_f1(&out, meta->accel_relax);
  w_int1(&out, meta->adaptive_scale);

  w_u32(&out, kExtMagic);
  w_u32(&out, kExtVersion);
  w_int1(&out, meta->cssize);
  w_ints(&out, cs, static_cast<size_t>(meta->cssize));
  w_int1(&out, meta->dsize);
  w_ints(&out, d, static_cast<size_t>(meta->dsize));
  w_int1(&out, meta->nucsize);
  w_ints(&out, nuc_m, static_cast<size_t>(meta->nucsize));
  w_ints(&out, nuc_n, static_cast<size_t>(meta->nucsize));
  w_int1(&out, meta->ell1size);
  w_ints(&out, ell1, static_cast<size_t>(meta->ell1size));
  w_int1(&out, meta->slsize);
  w_ints(&out, sl_n, static_cast<size_t>(meta->slsize));
  w_ints(&out, sl_k, static_cast<size_t>(meta->slsize));
  w_f1(&out, meta->time_limit);

  FILE* f = std::fopen(path, "wb");
  if (!f) {
    set_err(err, errlen, std::string("cannot open for write: ") + path);
    return -1;
  }
  const size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (wrote != out.size()) {
    set_err(err, errlen, "short write");
    return -1;
  }
  return static_cast<int64_t>(out.size());
}

// Standalone CSC -> row-major dense (data-loader fast path for callers
// holding scipy CSC arrays; avoids the interpreted per-column loop).
void csc_to_dense(int64_t m [[maybe_unused]], int64_t n, const int64_t* colptr,
                  const int64_t* rowidx, const double* vals, double* out) {
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t k = colptr[j]; k < colptr[j + 1]; ++k) {
      out[rowidx[k] * n + j] = vals[k];
    }
  }
}

// CSC structure validation (mirrors SCS(validate_lin_sys),
// linsys/scs_matrix.c:65-157): monotone colptr, in-range rows, finite
// values; returns 0 ok, else a negative error code.
int64_t csc_validate(int64_t m, int64_t n, const int64_t* colptr,
                     const int64_t* rowidx, const double* vals) {
  if (m <= 0 || n <= 0) return -1;
  if (colptr[0] != 0) return -2;
  for (int64_t j = 0; j < n; ++j) {
    if (colptr[j + 1] < colptr[j]) return -3;
  }
  const int64_t nnz = colptr[n];
  for (int64_t k = 0; k < nnz; ++k) {
    if (rowidx[k] < 0 || rowidx[k] >= m) return -4;
    if (!std::isfinite(vals[k])) return -5;
  }
  return 0;
}

}  // extern "C"
