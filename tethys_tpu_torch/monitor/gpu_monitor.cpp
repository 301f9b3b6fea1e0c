// GPU utilization monitor daemon: the port's twin of
// tethys_tpu/monitor/tpu_monitor.cpp, and of the reference's NVML sampler
// (reference NVML/NVML.cpp:1-93).
//
// NVML reads the card itself, so no bridge publishes metrics for this
// daemon: it loads libnvidia-ml.so.1 at run time (dlopen, with the few
// prototypes it calls declared below, so it builds with g++ alone, no CUDA
// toolkit) and samples every device at ~6 Hz (166.667 ms, compensating for
// the time a sample takes), printing the reference's exact line:
//
//   H:M:S:ms  Device 0: NVIDIA H100 80GB HBM3  GPU Util: 87  Mem Util: 41 Mem Usage: 6871947673
//
// GPU Util and Mem Util are nvmlDeviceGetUtilizationRates' gpu and memory
// percentages, Mem Usage nvmlDeviceGetMemoryInfo's used bytes.
// If NVML cannot be loaded, initialised or read, the daemon says why on
// stderr and exits 1: it never prints values it did not read.
// SIGINT and SIGTERM end the loop; NVML is shut down on the way out.
//
// Usage: gpu_monitor   (built by python -m tethys_tpu_torch.monitor.daemon)

#include <csignal>
#include <cstdio>
#include <cstdlib>
#include <ctime>

#include <dlfcn.h>
#include <sys/time.h>
#include <sys/timeb.h>
#include <unistd.h>

// The NVML types and entry points this daemon uses (nvml.h).
typedef int nvmlReturn_t;  // NVML_SUCCESS == 0
typedef struct nvmlDevice_st* nvmlDevice_t;
struct nvmlUtilization_t {
  unsigned int gpu;
  unsigned int memory;
};
struct nvmlMemory_t {
  unsigned long long total;
  unsigned long long free;
  unsigned long long used;
};
static const unsigned int kNameLength = 96;  // NVML_DEVICE_NAME_V2_BUFFER_SIZE

struct Nvml {
  nvmlReturn_t (*init)();
  nvmlReturn_t (*shutdown)();
  const char* (*error_string)(nvmlReturn_t);
  nvmlReturn_t (*device_count)(unsigned int*);
  nvmlReturn_t (*handle_by_index)(unsigned int, nvmlDevice_t*);
  nvmlReturn_t (*name)(nvmlDevice_t, char*, unsigned int);
  nvmlReturn_t (*utilization)(nvmlDevice_t, nvmlUtilization_t*);
  nvmlReturn_t (*memory)(nvmlDevice_t, nvmlMemory_t*);
};

static volatile sig_atomic_t g_run = 1;

static void signal_handler(int) {
  g_run = 0;
}

static void* symbol(void* lib, const char* name) {
  void* fn = dlsym(lib, name);
  if (fn == nullptr) {
    std::fprintf(stderr, "gpu_monitor: libnvidia-ml.so.1 has no %s\n", name);
    std::exit(1);
  }
  return fn;
}

static Nvml load_nvml() {
  void* lib = dlopen("libnvidia-ml.so.1", RTLD_NOW);
  if (lib == nullptr) {
    std::fprintf(stderr, "gpu_monitor: cannot load libnvidia-ml.so.1: %s\n",
                 dlerror());
    std::exit(1);
  }
  Nvml n;
  n.init = reinterpret_cast<nvmlReturn_t (*)()>(symbol(lib, "nvmlInit_v2"));
  n.shutdown = reinterpret_cast<nvmlReturn_t (*)()>(symbol(lib, "nvmlShutdown"));
  n.error_string = reinterpret_cast<const char* (*)(nvmlReturn_t)>(
      symbol(lib, "nvmlErrorString"));
  n.device_count = reinterpret_cast<nvmlReturn_t (*)(unsigned int*)>(
      symbol(lib, "nvmlDeviceGetCount_v2"));
  n.handle_by_index =
      reinterpret_cast<nvmlReturn_t (*)(unsigned int, nvmlDevice_t*)>(
          symbol(lib, "nvmlDeviceGetHandleByIndex_v2"));
  n.name = reinterpret_cast<nvmlReturn_t (*)(nvmlDevice_t, char*, unsigned int)>(
      symbol(lib, "nvmlDeviceGetName"));
  n.utilization =
      reinterpret_cast<nvmlReturn_t (*)(nvmlDevice_t, nvmlUtilization_t*)>(
          symbol(lib, "nvmlDeviceGetUtilizationRates"));
  n.memory = reinterpret_cast<nvmlReturn_t (*)(nvmlDevice_t, nvmlMemory_t*)>(
      symbol(lib, "nvmlDeviceGetMemoryInfo"));
  return n;
}

// Exits 1 with NVML's reason unless ret is NVML_SUCCESS; ``initialised``:
// shut NVML down first.
static void check(const Nvml& nvml, nvmlReturn_t ret, const char* what,
                  bool initialised = true) {
  if (ret != 0) {
    std::fprintf(stderr, "gpu_monitor: %s failed: %s (%d)\n", what,
                 nvml.error_string(ret), ret);
    if (initialised) nvml.shutdown();
    std::exit(1);
  }
}

int main() {
  std::signal(SIGINT, signal_handler);
  std::signal(SIGTERM, signal_handler);
  setvbuf(stdout, nullptr, _IONBF, 0);  // unbuffered, like the reference

  const Nvml nvml = load_nvml();
  check(nvml, nvml.init(), "nvmlInit", false);
  unsigned int count = 0;
  check(nvml, nvml.device_count(&count), "nvmlDeviceGetCount");
  if (count == 0) {
    std::fprintf(stderr, "gpu_monitor: NVML sees no device\n");
    nvml.shutdown();
    return 1;
  }

  const long kPeriodUs = 166667;  // ~6 Hz, reference cadence

  while (g_run) {
    struct timeval start, fin;
    gettimeofday(&start, nullptr);

    time_t now = time(nullptr);
    struct tm tm_now;
    localtime_r(&now, &tm_now);
    struct timeb timer_msec;
    ftime(&timer_msec);

    for (unsigned int i = 0; i < count; ++i) {
      nvmlDevice_t device;
      char name[kNameLength] = {0};
      nvmlUtilization_t util;
      nvmlMemory_t mem;
      check(nvml, nvml.handle_by_index(i, &device),
            "nvmlDeviceGetHandleByIndex");
      check(nvml, nvml.name(device, name, kNameLength), "nvmlDeviceGetName");
      check(nvml, nvml.utilization(device, &util),
            "nvmlDeviceGetUtilizationRates");
      check(nvml, nvml.memory(device, &mem), "nvmlDeviceGetMemoryInfo");
      std::printf("%d:%d:%d:%d  ", tm_now.tm_hour, tm_now.tm_min,
                  tm_now.tm_sec, timer_msec.millitm);
      std::printf("Device %u: %s  ", i, name);
      std::printf("GPU Util: %u  Mem Util: %u Mem Usage: %lli\n ",
                  util.gpu, util.memory,
                  static_cast<long long>(mem.used));
    }

    gettimeofday(&fin, nullptr);
    long elapsed = (fin.tv_sec - start.tv_sec) * 1000000L +
                   (fin.tv_usec - start.tv_usec);
    long sleep_us = kPeriodUs - elapsed;
    if (sleep_us > 0) usleep(static_cast<useconds_t>(sleep_us));
  }
  nvml.shutdown();
  return 0;
}
