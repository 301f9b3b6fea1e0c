"""The GPU utilization monitor (tethys_tpu/monitor/): a C++ daemon that
reads the card through NVML (``gpu_monitor.cpp``), built at first use
(``daemon.py``) and started by ``gpu.sh``."""
