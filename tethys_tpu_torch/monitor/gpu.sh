#!/bin/bash
# GPU monitor capture (the port's twin of scripts/tpu.sh, reference
# gpu.sh:1-8): runs the NVML daemon in the background, its lines going to
# the job's result file ${RESULT}/${MODEL}/${JOB}_gpu.txt.  The jobs start
# <workspace>/gpu.sh (utils/artifacts.start_side_captures); run it from a
# directory where python3 imports tethys_tpu_torch (the checkout's root).

WORKSPACE=${TETHYS_WORKSPACE:-/workspace}
RESULT=${TETHYS_RESULT:-/result}

JOB=`python3 -m tethys_tpu_torch.scripts.job_name`;

MODEL=`cat ${WORKSPACE}/model.txt`;

python3 -m tethys_tpu_torch.monitor.daemon > ${RESULT}/${MODEL}/${JOB}_gpu.txt &
