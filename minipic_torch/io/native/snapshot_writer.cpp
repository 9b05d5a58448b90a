// Async HDF5 snapshot writer — the native half of the IO runtime.
//
// The reference writes snapshots synchronously from its main loop through
// the HDF5 C++ API (HDF5_output.cpp:10-79), stalling the step loop for
// every save.  Here a C++ thread pool owns serialization: the Python
// driver hands over a copied buffer per rank-file and returns to stepping
// immediately; files appear in the same schema (one group per tile,
// compound {Ex..Bz} double dataset including guards, int attrs).
//
// Built against the system libhdf5 runtime with hand-declared prototypes
// (no headers shipped in this image).  The HDF5 1.x C ABI is stable; the
// predefined type IDs are runtime globals (H5T_NATIVE_*_g) initialized by
// H5open(), exactly as the real H5Tpublic.h macros resolve them.
//
// Exposed C API (ctypes, see __init__.py beside this file):
//   int  mpw_init(int n_threads);
//   int  mpw_submit(const char* path,
//                   int n_tiles, const int* gids, const int* rows,
//                   const int* cols, int rank, const double* data,
//                   long long tile_ny_g, long long tile_nx_g);
//        // data layout: [n_tiles][tile_ny_g][tile_nx_g][6] doubles,
//        // component order Ex,Ey,Ez,Bx,By,Bz (the compound struct order).
//   int  mpw_flush();      // block until the queue drains; returns #errors
//   long mpw_written();    // files successfully written so far
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// ---- hand-declared HDF5 C ABI (1.10 series, libhdf5_serial.so.103) ----
extern "C" {
typedef int64_t hid_t;
typedef int herr_t;
typedef unsigned long long hsize_t;

herr_t H5open(void);
hid_t H5Fcreate(const char *name, unsigned flags, hid_t fcpl, hid_t fapl);
herr_t H5Fclose(hid_t);
hid_t H5Gcreate2(hid_t loc, const char *name, hid_t lcpl, hid_t gcpl, hid_t gapl);
herr_t H5Gclose(hid_t);
hid_t H5Screate(int type);                       // H5S_class_t
hid_t H5Screate_simple(int rank, const hsize_t *dims, const hsize_t *maxdims);
herr_t H5Sclose(hid_t);
hid_t H5Tcreate(int cls, size_t size);           // H5T_class_t
herr_t H5Tinsert(hid_t parent, const char *name, size_t offset, hid_t member);
herr_t H5Tclose(hid_t);
hid_t H5Dcreate2(hid_t loc, const char *name, hid_t type, hid_t space,
                 hid_t lcpl, hid_t dcpl, hid_t dapl);
herr_t H5Dwrite(hid_t dset, hid_t memtype, hid_t memspace, hid_t filespace,
                hid_t xfer, const void *buf);
herr_t H5Dclose(hid_t);
hid_t H5Acreate2(hid_t loc, const char *name, hid_t type, hid_t space,
                 hid_t acpl, hid_t aapl);
herr_t H5Awrite(hid_t attr, hid_t memtype, const void *buf);
herr_t H5Aclose(hid_t);

// Predefined-type runtime globals (what the H5T_NATIVE_* macros expand to).
extern hid_t H5T_NATIVE_DOUBLE_g;
extern hid_t H5T_NATIVE_INT_g;
}

static const unsigned H5F_ACC_TRUNC_ = 0x0002u;
static const hid_t H5P_DEFAULT_ = 0;
static const int H5S_SCALAR_ = 0;  // H5S_class_t
static const int H5T_COMPOUND_ = 6;  // H5T_class_t

// ------------------------------------------------------------------ jobs
struct Job {
  int kind = 0;  // 0 = field snapshot, 1 = particle snapshot
  std::string path;
  // kind 0 (fields): one group per tile, compound dataset
  std::vector<int> gids, rows, cols;
  int rank = 0;
  std::vector<double> data;  // fields: [n_tiles][ny][nx][6];
                             // particles: per species 6 arrays of count
  long long ny = 0, nx = 0;
  // kind 1 (particles): one group per species, 6 flat double datasets
  std::vector<std::string> species;
  std::vector<long long> counts;
};

static std::deque<Job> g_queue;
static std::mutex g_mu;
static std::condition_variable g_cv;
static std::vector<std::thread> g_threads;
static std::atomic<bool> g_stop{false};
static std::atomic<long> g_written{0};
static std::atomic<long> g_errors{0};
static std::atomic<long> g_inflight{0};

static int write_file(const Job &j) {
  const size_t cell = 6;  // doubles per grid cell
  hid_t file = H5Fcreate(j.path.c_str(), H5F_ACC_TRUNC_, H5P_DEFAULT_, H5P_DEFAULT_);
  if (file < 0) return -1;

  hid_t gridType = H5Tcreate(H5T_COMPOUND_, cell * sizeof(double));
  const char *names[6] = {"Ex", "Ey", "Ez", "Bx", "By", "Bz"};
  for (int c = 0; c < 6; ++c)
    H5Tinsert(gridType, names[c], c * sizeof(double), H5T_NATIVE_DOUBLE_g);

  int bad = 0;
  const size_t tile_elems = (size_t)j.ny * j.nx * cell;
  for (size_t t = 0; t < j.gids.size(); ++t) {
    std::string gname = "Tile_" + std::to_string(j.gids[t]);
    hid_t grp = H5Gcreate2(file, gname.c_str(), H5P_DEFAULT_, H5P_DEFAULT_, H5P_DEFAULT_);
    if (grp < 0) { bad++; continue; }
    hsize_t dims[2] = {(hsize_t)j.ny, (hsize_t)j.nx};
    hid_t space = H5Screate_simple(2, dims, nullptr);
    hid_t dset = H5Dcreate2(grp, "fields", gridType, space, H5P_DEFAULT_, H5P_DEFAULT_, H5P_DEFAULT_);
    if (dset < 0 ||
        H5Dwrite(dset, gridType, H5P_DEFAULT_, H5P_DEFAULT_, H5P_DEFAULT_,
                 j.data.data() + t * tile_elems) < 0)
      bad++;
    // int attrs: tileRow, tileCol, currentRank (HDF5_output.cpp:47-67)
    const char *anames[3] = {"tileRow", "tileCol", "currentRank"};
    int avals[3] = {j.rows[t], j.cols[t], j.rank};
    for (int a = 0; a < 3; ++a) {
      hid_t aspace = H5Screate(H5S_SCALAR_);
      hid_t attr = H5Acreate2(grp, anames[a], H5T_NATIVE_INT_g, aspace, H5P_DEFAULT_, H5P_DEFAULT_);
      if (attr < 0 || H5Awrite(attr, H5T_NATIVE_INT_g, &avals[a]) < 0) bad++;
      if (attr >= 0) H5Aclose(attr);
      H5Sclose(aspace);
    }
    if (dset >= 0) H5Dclose(dset);
    H5Sclose(space);
    H5Gclose(grp);
  }
  H5Tclose(gridType);
  H5Fclose(file);
  return bad ? -1 : 0;
}

// Particle snapshot: /{species}/x..w 1-D double datasets of the live
// particles only, plus an int `count` attr per group.  No reference schema
// exists (the reference never wrote particles); this is the native-runtime
// analogue of its per-rank field files.
static int write_particle_file(const Job &j) {
  hid_t file = H5Fcreate(j.path.c_str(), H5F_ACC_TRUNC_, H5P_DEFAULT_, H5P_DEFAULT_);
  if (file < 0) return -1;
  int bad = 0;
  const char *comps[6] = {"x", "y", "px", "py", "pz", "w"};
  size_t off = 0;
  for (size_t s = 0; s < j.species.size(); ++s) {
    hid_t grp = H5Gcreate2(file, j.species[s].c_str(), H5P_DEFAULT_, H5P_DEFAULT_, H5P_DEFAULT_);
    if (grp < 0) { bad++; off += (size_t)j.counts[s] * 6; continue; }
    hsize_t dims[1] = {(hsize_t)j.counts[s]};
    for (int c = 0; c < 6; ++c) {
      hid_t space = H5Screate_simple(1, dims, nullptr);
      hid_t dset = H5Dcreate2(grp, comps[c], H5T_NATIVE_DOUBLE_g, space,
                              H5P_DEFAULT_, H5P_DEFAULT_, H5P_DEFAULT_);
      if (dset < 0 ||
          H5Dwrite(dset, H5T_NATIVE_DOUBLE_g, H5P_DEFAULT_, H5P_DEFAULT_,
                   H5P_DEFAULT_, j.data.data() + off) < 0)
        bad++;
      if (dset >= 0) H5Dclose(dset);
      H5Sclose(space);
      off += (size_t)j.counts[s];
    }
    int cnt = (int)j.counts[s];
    hid_t aspace = H5Screate(H5S_SCALAR_);
    hid_t attr = H5Acreate2(grp, "count", H5T_NATIVE_INT_g, aspace, H5P_DEFAULT_, H5P_DEFAULT_);
    if (attr < 0 || H5Awrite(attr, H5T_NATIVE_INT_g, &cnt) < 0) bad++;
    if (attr >= 0) H5Aclose(attr);
    H5Sclose(aspace);
    H5Gclose(grp);
  }
  H5Fclose(file);
  return bad ? -1 : 0;
}

static void worker() {
  for (;;) {
    Job j;
    {
      std::unique_lock<std::mutex> lk(g_mu);
      g_cv.wait(lk, [] { return g_stop.load() || !g_queue.empty(); });
      if (g_queue.empty()) {
        if (g_stop) return;
        continue;
      }
      j = std::move(g_queue.front());
      g_queue.pop_front();
    }
    if ((j.kind == 1 ? write_particle_file(j) : write_file(j)) == 0)
      g_written++;
    else
      g_errors++;
    {
      // Decrement under the lock so the predicate change is ordered with
      // mpw_flush's condition_variable wait (otherwise a flush that checks
      // the predicate between our decrement and notify can miss the final
      // wakeup and block until an unrelated job completes).
      std::lock_guard<std::mutex> lk(g_mu);
      g_inflight--;
    }
    g_cv.notify_all();
  }
}

extern "C" {

int mpw_init(int n_threads) {
  if (H5open() < 0) return -1;
  if (!g_threads.empty()) return 0;
  g_stop = false;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i) g_threads.emplace_back(worker);
  return 0;
}

int mpw_submit(const char *path, int n_tiles, const int *gids, const int *rows,
               const int *cols, int rank, const double *data,
               long long tile_ny_g, long long tile_nx_g) {
  if (g_threads.empty()) return -1;
  Job j;
  j.path = path;
  j.gids.assign(gids, gids + n_tiles);
  j.rows.assign(rows, rows + n_tiles);
  j.cols.assign(cols, cols + n_tiles);
  j.rank = rank;
  j.ny = tile_ny_g;
  j.nx = tile_nx_g;
  j.data.assign(data, data + (size_t)n_tiles * tile_ny_g * tile_nx_g * 6);
  {
    std::lock_guard<std::mutex> lk(g_mu);
    g_queue.push_back(std::move(j));
    g_inflight++;
  }
  g_cv.notify_one();
  return 0;
}

int mpw_submit_particles(const char *path, int n_species, const char **names,
                         const long long *counts, const double *data) {
  if (g_threads.empty()) return -1;
  Job j;
  j.kind = 1;
  j.path = path;
  size_t total = 0;
  for (int s = 0; s < n_species; ++s) {
    j.species.emplace_back(names[s]);
    j.counts.push_back(counts[s]);
    total += (size_t)counts[s] * 6;
  }
  j.data.assign(data, data + total);
  {
    std::lock_guard<std::mutex> lk(g_mu);
    g_queue.push_back(std::move(j));
    g_inflight++;
  }
  g_cv.notify_one();
  return 0;
}

int mpw_flush() {
  std::unique_lock<std::mutex> lk(g_mu);
  g_cv.wait(lk, [] { return g_inflight.load() == 0; });
  return (int)g_errors.exchange(0);
}

long mpw_written() { return g_written.load(); }

void mpw_shutdown() {
  {
    std::lock_guard<std::mutex> lk(g_mu);
    g_stop = true;
  }
  g_cv.notify_all();
  for (auto &t : g_threads) t.join();
  g_threads.clear();
}
}
