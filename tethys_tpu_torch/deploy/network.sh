#!/bin/bash
# Network traffic capture (the twin of the reference's network.sh:1-9).
# Across hosts the gradient all-reduce of the data-parallel jobs is NCCL
# over the NIC, which tcpdump sees here; between the GPUs of one host NCCL
# goes over NVLink or PCIe, which no NIC observes: each job reports the
# bytes it hands to every collective in <task>_<idx>_collectives.txt
# (tethys_tpu_torch/profiling/comm.py).  The jobs start
# <workspace>/network.sh (utils/artifacts.start_side_captures).

WORKSPACE=${TETHYS_WORKSPACE:-/workspace}
RESULT=${TETHYS_RESULT:-/result}

JOB=`python3 -m tethys_tpu_torch.scripts.job_name`;
IP=`ifconfig eth0 | grep 'inet ' | awk '{print $2}'`;

MODEL=`cat ${WORKSPACE}/model.txt`;

tcpdump host ${IP} -s 64 -w ${RESULT}/${MODEL}/${JOB}_${IP}_network.pcap &
