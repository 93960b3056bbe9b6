// dl4j_hdf5 — minimal C++ HDF5 reader/writer for Keras model import
// (the PyTorch port's copy of `deeplearning4j_tpu/native/hdf5/`).
//
// A thin native layer over libhdf5 exposing exactly the operations
// Keras import needs (string attributes, group listing, float32 dataset
// read/write, group creation), consumed from Python through ctypes
// (deeplearning4j_tpu_torch/modelimport/hdf5.py), the role
// deeplearning4j-modelimport's Hdf5Archive.java gives JavaCPP.
//
// Hosts often ship libhdf5_serial.so without headers, so the needed C
// API surface (HDF5 1.10 ABI: hid_t = int64) is declared here directly.
//
// Build (deeplearning4j_tpu_torch/util/native_build.py does it at first
// use, into build/native/):
//   g++ -O2 -fPIC -shared dl4j_hdf5.cpp -o libdl4j_hdf5.so \
//       -l:libhdf5_serial.so.103
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ----------------------------------------------------------------- HDF5 ABI
typedef int64_t hid_t;
typedef int herr_t;
typedef unsigned long long hsize_t;
typedef int htri_t;

#define H5P_DEFAULT ((hid_t)0)
#define H5S_ALL ((hid_t)0)
#define H5F_ACC_RDONLY 0u
#define H5F_ACC_TRUNC 2u
#define H5T_VARIABLE ((size_t)-1)
#define H5S_SCALAR 0

herr_t H5open(void);
hid_t H5Fopen(const char *, unsigned, hid_t);
hid_t H5Fcreate(const char *, unsigned, hid_t, hid_t);
herr_t H5Fclose(hid_t);
hid_t H5Gcreate2(hid_t, const char *, hid_t, hid_t, hid_t);
herr_t H5Gclose(hid_t);
hid_t H5Oopen(hid_t, const char *, hid_t);
herr_t H5Oclose(hid_t);
hid_t H5Dopen2(hid_t, const char *, hid_t);
herr_t H5Dclose(hid_t);
hid_t H5Dget_space(hid_t);
hid_t H5Dget_type(hid_t);
herr_t H5Dread(hid_t, hid_t, hid_t, hid_t, hid_t, void *);
hid_t H5Dcreate2(hid_t, const char *, hid_t, hid_t, hid_t, hid_t, hid_t);
herr_t H5Dwrite(hid_t, hid_t, hid_t, hid_t, hid_t, const void *);
hid_t H5Screate(int);
hid_t H5Screate_simple(int, const hsize_t *, const hsize_t *);
int H5Sget_simple_extent_ndims(hid_t);
int H5Sget_simple_extent_dims(hid_t, hsize_t *, hsize_t *);
hsize_t H5Sget_simple_extent_npoints(hid_t);
herr_t H5Sclose(hid_t);
hid_t H5Aopen(hid_t, const char *, hid_t);
hid_t H5Acreate2(hid_t, const char *, hid_t, hid_t, hid_t, hid_t);
herr_t H5Aread(hid_t, hid_t, void *);
herr_t H5Awrite(hid_t, hid_t, const void *);
hid_t H5Aget_type(hid_t);
hid_t H5Aget_space(hid_t);
herr_t H5Aclose(hid_t);
htri_t H5Aexists(hid_t, const char *);
hid_t H5Tcopy(hid_t);
herr_t H5Tset_size(hid_t, size_t);
size_t H5Tget_size(hid_t);
htri_t H5Tis_variable_str(hid_t);
herr_t H5Tclose(hid_t);
htri_t H5Lexists(hid_t, const char *, hid_t);
herr_t H5Eset_auto2(hid_t, void *, void *);
hid_t H5Pcreate(hid_t);
herr_t H5Pset_libver_bounds(hid_t, int, int);
herr_t H5Pclose(hid_t);
hid_t H5Gopen2(hid_t, const char *, hid_t);
typedef struct H5L_info_t H5L_info_t;
typedef herr_t (*H5L_iterate_t)(hid_t, const char *, const H5L_info_t *,
                                void *);
// H5Literate is a macro in 1.14 (symbol H5Literate1); weak-declare both
// spellings and pick whichever the loaded libhdf5 exports.
extern herr_t H5Literate(hid_t, int, int, hsize_t *, H5L_iterate_t, void *)
    __attribute__((weak));
extern herr_t H5Literate1(hid_t, int, int, hsize_t *, H5L_iterate_t, void *)
    __attribute__((weak));

// global type ids (the H5T_NATIVE_* macros resolve to these globals)
extern hid_t H5T_C_S1_g;
extern hid_t H5T_NATIVE_FLOAT_g;
extern hid_t H5T_NATIVE_DOUBLE_g;
extern hid_t H5T_NATIVE_INT_g;
extern hid_t H5T_NATIVE_LLONG_g;
extern hid_t H5P_CLS_FILE_ACCESS_ID_g;  // H5P_FILE_ACCESS

// ----------------------------------------------------------------- helpers
static bool g_inited = false;
static void ensure_init() {
  if (!g_inited) {
    H5open();
    H5Eset_auto2(0, nullptr, nullptr);  // silence stderr spew; we return codes
    g_inited = true;
  }
}

// --------------------------------------------------------------- file ops
int64_t dl4j_h5_open(const char *path) {
  ensure_init();
  return (int64_t)H5Fopen(path, H5F_ACC_RDONLY, H5P_DEFAULT);
}

// Files are written in the HDF5 1.8 format (H5F_LIBVER_V18 = 1 as both
// bounds): its dense attribute storage holds attributes past the 64 KiB
// object-header limit, such as a full-depth model's `model_config`
// (keras ResNet-50's is 163 KB). Every reader since HDF5 1.8 reads it.
int64_t dl4j_h5_create(const char *path) {
  ensure_init();
  hid_t fapl = H5Pcreate(H5P_CLS_FILE_ACCESS_ID_g);
  if (fapl < 0) return -1;
  hid_t f = -1;
  if (H5Pset_libver_bounds(fapl, 1, 1) >= 0)
    f = H5Fcreate(path, H5F_ACC_TRUNC, H5P_DEFAULT, fapl);
  H5Pclose(fapl);
  return (int64_t)f;
}

int dl4j_h5_close(int64_t file) { return (int)H5Fclose((hid_t)file); }

int dl4j_h5_exists(int64_t file, const char *path) {
  // checks each component so intermediate groups may be missing
  std::string p(path);
  std::string cur;
  size_t start = p[0] == '/' ? 1 : 0;
  while (start <= p.size()) {
    size_t slash = p.find('/', start);
    if (slash == std::string::npos) slash = p.size();
    cur += "/" + p.substr(start, slash - start);
    if (H5Lexists((hid_t)file, cur.c_str(), H5P_DEFAULT) <= 0) return 0;
    start = slash + 1;
  }
  return 1;
}

int dl4j_h5_create_group(int64_t file, const char *path) {
  hid_t g = H5Gcreate2((hid_t)file, path, H5P_DEFAULT, H5P_DEFAULT, H5P_DEFAULT);
  if (g < 0) return -1;
  H5Gclose(g);
  return 0;
}

// ------------------------------------------------------------ attributes
// Read a string attribute (scalar or 1-D array; fixed or variable-length)
// on the object at `obj_path`. Multiple values are '\n'-joined into
// `out` (caller-allocated, out_len bytes). Returns #values or -1.
int dl4j_h5_read_string_attr(int64_t file, const char *obj_path,
                             const char *attr_name, char *out,
                             int64_t out_len) {
  ensure_init();
  hid_t obj = H5Oopen((hid_t)file, obj_path, H5P_DEFAULT);
  if (obj < 0) return -1;
  if (H5Aexists(obj, attr_name) <= 0) { H5Oclose(obj); return -1; }
  hid_t attr = H5Aopen(obj, attr_name, H5P_DEFAULT);
  if (attr < 0) { H5Oclose(obj); return -1; }
  hid_t ftype = H5Aget_type(attr);
  hid_t space = H5Aget_space(attr);
  hsize_t n = H5Sget_simple_extent_npoints(space);
  if (n == 0) n = 1;
  std::string joined;
  int count = 0;
  if (H5Tis_variable_str(ftype) > 0) {
    hid_t mtype = H5Tcopy(H5T_C_S1_g);
    H5Tset_size(mtype, H5T_VARIABLE);
    std::vector<char *> bufs(n, nullptr);
    if (H5Aread(attr, mtype, bufs.data()) >= 0) {
      for (hsize_t i = 0; i < n; i++) {
        if (i) joined += "\n";
        if (bufs[i]) { joined += bufs[i]; free(bufs[i]); }
        count++;
      }
    }
    H5Tclose(mtype);
  } else {
    size_t sz = H5Tget_size(ftype);
    std::vector<char> buf(n * (sz + 1), 0);
    hid_t mtype = H5Tcopy(H5T_C_S1_g);
    H5Tset_size(mtype, sz + 1);  // room for forced NUL
    // read with the FILE type then re-chunk (fixed strings may lack NUL)
    std::vector<char> raw(n * sz, 0);
    if (H5Aread(attr, ftype, raw.data()) >= 0) {
      for (hsize_t i = 0; i < n; i++) {
        if (i) joined += "\n";
        std::string s(raw.data() + i * sz, sz);
        s.resize(strnlen(s.c_str(), sz));
        joined += s;
        count++;
      }
    }
    H5Tclose(mtype);
  }
  H5Tclose(ftype);
  H5Sclose(space);
  H5Aclose(attr);
  H5Oclose(obj);
  if ((int64_t)joined.size() + 1 > out_len) return -2;  // buffer too small
  memcpy(out, joined.c_str(), joined.size() + 1);
  return count;
}

// Write a scalar fixed-length string attribute.
int dl4j_h5_write_string_attr(int64_t file, const char *obj_path,
                              const char *attr_name, const char *value) {
  hid_t obj = H5Oopen((hid_t)file, obj_path, H5P_DEFAULT);
  if (obj < 0) return -1;
  size_t len = strlen(value);
  hid_t type = H5Tcopy(H5T_C_S1_g);
  H5Tset_size(type, len > 0 ? len : 1);
  hid_t space = H5Screate(H5S_SCALAR);
  hid_t attr = H5Acreate2(obj, attr_name, type, space, H5P_DEFAULT, H5P_DEFAULT);
  int rc = -1;
  if (attr >= 0) {
    rc = (int)H5Awrite(attr, type, value);
    H5Aclose(attr);
  }
  H5Sclose(space);
  H5Tclose(type);
  H5Oclose(obj);
  return rc;
}

// Write a 1-D fixed-length string-array attribute; `values` are
// '\n'-separated.
int dl4j_h5_write_string_array_attr(int64_t file, const char *obj_path,
                                    const char *attr_name,
                                    const char *values) {
  std::vector<std::string> items;
  std::string cur;
  for (const char *p = values;; p++) {
    if (*p == '\n' || *p == '\0') {
      items.push_back(cur);
      cur.clear();
      if (*p == '\0') break;
    } else {
      cur += *p;
    }
  }
  size_t maxlen = 1;
  for (auto &s : items) maxlen = s.size() > maxlen ? s.size() : maxlen;
  hid_t obj = H5Oopen((hid_t)file, obj_path, H5P_DEFAULT);
  if (obj < 0) return -1;
  hid_t type = H5Tcopy(H5T_C_S1_g);
  H5Tset_size(type, maxlen);
  hsize_t n = items.size();
  hid_t space = H5Screate_simple(1, &n, nullptr);
  std::vector<char> buf(n * maxlen, 0);
  for (size_t i = 0; i < items.size(); i++)
    memcpy(buf.data() + i * maxlen, items[i].c_str(), items[i].size());
  hid_t attr = H5Acreate2(obj, attr_name, type, space, H5P_DEFAULT, H5P_DEFAULT);
  int rc = -1;
  if (attr >= 0) {
    rc = (int)H5Awrite(attr, type, buf.data());
    H5Aclose(attr);
  }
  H5Sclose(space);
  H5Tclose(type);
  H5Oclose(obj);
  return rc;
}

// ---------------------------------------------------------------- listing
static herr_t dl4j_list_cb(hid_t, const char *name, const H5L_info_t *,
                           void *op) {
  auto *s = (std::string *)op;
  if (!s->empty()) *s += "\n";
  *s += name;
  return 0;
}

// List immediate child link names of the group at `path`, '\n'-joined,
// in ascending name order. Returns #children, -1 on error, -2 if the
// caller buffer is too small.
int dl4j_h5_list_children(int64_t file, const char *path, char *out,
                          int64_t out_len) {
  ensure_init();
  hid_t g = H5Gopen2((hid_t)file, path, H5P_DEFAULT);
  if (g < 0) return -1;
  std::string names;
  herr_t rc = -1;
  // H5_INDEX_NAME = 0, H5_ITER_INC = 0
  if (&H5Literate != nullptr)
    rc = H5Literate(g, 0, 0, nullptr, dl4j_list_cb, &names);
  else if (&H5Literate1 != nullptr)
    rc = H5Literate1(g, 0, 0, nullptr, dl4j_list_cb, &names);
  H5Gclose(g);
  if (rc < 0) return -1;
  if ((int64_t)names.size() + 1 > out_len) return -2;
  memcpy(out, names.c_str(), names.size() + 1);
  int count = names.empty() ? 0 : 1;
  for (char c : names)
    if (c == '\n') count++;
  return count;
}

// -------------------------------------------------------------- datasets
// Shape query: fills dims[0..ndim-1], returns ndim or -1.
int dl4j_h5_dataset_ndim(int64_t file, const char *path, int64_t *dims,
                         int max_ndim) {
  hid_t ds = H5Dopen2((hid_t)file, path, H5P_DEFAULT);
  if (ds < 0) return -1;
  hid_t space = H5Dget_space(ds);
  int nd = H5Sget_simple_extent_ndims(space);
  if (nd >= 0 && nd <= max_ndim) {
    std::vector<hsize_t> hd(nd > 0 ? nd : 1);
    H5Sget_simple_extent_dims(space, hd.data(), nullptr);
    for (int i = 0; i < nd; i++) dims[i] = (int64_t)hd[i];
  }
  H5Sclose(space);
  H5Dclose(ds);
  return nd;
}

// Read full dataset as float32 into caller buffer.
int dl4j_h5_read_dataset_f32(int64_t file, const char *path, float *out) {
  hid_t ds = H5Dopen2((hid_t)file, path, H5P_DEFAULT);
  if (ds < 0) return -1;
  herr_t rc = H5Dread(ds, H5T_NATIVE_FLOAT_g, H5S_ALL, H5S_ALL, H5P_DEFAULT, out);
  H5Dclose(ds);
  return (int)rc;
}

// Create + write a float32 dataset.
int dl4j_h5_write_dataset_f32(int64_t file, const char *path,
                              const int64_t *dims, int ndim,
                              const float *data) {
  std::vector<hsize_t> hd(ndim > 0 ? ndim : 1);
  for (int i = 0; i < ndim; i++) hd[i] = (hsize_t)dims[i];
  hid_t space = ndim > 0 ? H5Screate_simple(ndim, hd.data(), nullptr)
                         : H5Screate(H5S_SCALAR);
  hid_t ds = H5Dcreate2((hid_t)file, path, H5T_NATIVE_FLOAT_g, space,
                        H5P_DEFAULT, H5P_DEFAULT, H5P_DEFAULT);
  int rc = -1;
  if (ds >= 0) {
    rc = (int)H5Dwrite(ds, H5T_NATIVE_FLOAT_g, H5S_ALL, H5S_ALL, H5P_DEFAULT,
                       data);
    H5Dclose(ds);
  }
  H5Sclose(space);
  return rc;
}

}  // extern "C"
