"""The port's deployment files (tethys_tpu_torch/deploy/): the Kubeflow
TFJob manifests parse and keep the reference's layout and contract, every
command they and the Dockerfile run parses with the port job's own
parser, every COPY source of the Dockerfile exists, and network.sh is a
valid shell script about NCCL.  Nothing is built: a build pulls the base
image."""

import pathlib
import shlex
import subprocess

import pytest
import yaml

from tethys_tpu_torch.jobs import wav2vec2_dist, whisper_dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "tethys_tpu_torch" / "deploy"
JOBS = {"whisper": whisper_dist, "wav2vec2": wav2vec2_dist}


def _job_argv(script: str, family: str) -> list:
    """The argv of the ``python -m tethys_tpu_torch.jobs.<family>_dist``
    line of a container's shell script, up to its redirection."""
    for line in script.splitlines():
        if f"tethys_tpu_torch.jobs.{family}_dist" in line:
            words = shlex.split(line.split(">")[0])
            return words[words.index("-m") + 2:]
    raise AssertionError(f"no {family}_dist line in {script!r}")


@pytest.mark.parametrize("family", ["whisper", "wav2vec2"])
def test_manifest_is_the_reference_tfjob(family):
    doc = yaml.safe_load((DEPLOY / f"{family}-dist.yaml").read_text())
    assert (doc["apiVersion"], doc["kind"]) == ("kubeflow.org/v1", "TFJob")
    assert doc["metadata"]["name"] == f"speech-{family}-sync-batch8"
    specs = doc["spec"]["tfReplicaSpecs"]
    assert list(specs) == ["Chief", "Worker"]
    for role, spec in specs.items():
        assert spec["replicas"] == 1 and spec["restartPolicy"] == "Never"
        (container,) = spec["template"]["spec"]["containers"]
        assert container["name"] == "tensorflow"
        assert container["resources"]["limits"] == {"nvidia.com/gpu": 1}
        assert container["ports"] == [{"containerPort": 2222,
                                       "name": "tfjob-port"}]
        mounts = {m["mountPath"] for m in container["volumeMounts"]}
        assert {"/result", "/workspace"} <= mounts
        (script,) = container["args"]
        for piece in ("mkdir -p /result/${JOB_NAME}",
                      'echo "${JOB_NAME}" > /workspace/model.txt',
                      "python3 -m tethys_tpu_torch.scripts.job_name",
                      "_start_time.txt", "_end_time.txt",
                      "top -d 0.1 -b | grep python",
                      "_log.txt 2>&1"):
            assert piece in script, (role, piece)
        args = JOBS[family].build_parser().parse_args(
            _job_argv(script, family))
        assert (args.batch_size, args.num_batches) == (4, 30)
        assert args.device == "cuda"


def _dockerfile() -> list:
    """(instruction, rest) of each line of the Dockerfile, continuation
    lines joined."""
    text = (DEPLOY / "Dockerfile").read_text().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word, rest.strip()))
    return out


def test_dockerfile_copies_what_exists_and_runs_the_port():
    lines = _dockerfile()
    assert lines[0][0] == "FROM" and "nvidia" in lines[0][1]
    copies = [rest.split() for word, rest in lines if word == "COPY"]
    sources = {src for src, _ in copies}
    assert sources == {"tethys_tpu_torch", "tethys_tpu_torch/monitor/gpu.sh",
                       "tethys_tpu_torch/deploy/network.sh",
                       "tethys_tpu_torch/scripts/job_name.py"}
    for src in sources:
        assert (ROOT / src).exists(), src
    assert (ROOT / "tethys_tpu_torch/monitor/gpu_monitor.cpp").exists()
    assert {dst for _, dst in copies} >= {"/workspace/gpu.sh",
                                         "/workspace/network.sh",
                                         "/workspace/job_name.py"}
    runs = [rest for word, rest in lines if word == "RUN"]
    assert "python -m tethys_tpu_torch.monitor.daemon --build" in runs
    (cmd,) = [rest for word, rest in lines if word == "CMD"]
    argv = yaml.safe_load(cmd)         # a JSON array
    assert argv[:3] == ["python", "-m", "tethys_tpu_torch.jobs.whisper_dist"]
    args = whisper_dist.build_parser().parse_args(argv[3:])
    assert (args.batch_size, args.num_batches) == (4, 30)
    assert "jax" not in (DEPLOY / "Dockerfile").read_text().lower()


def test_network_script_is_valid_and_about_nccl():
    path = DEPLOY / "network.sh"
    text = path.read_text()
    subprocess.run(["bash", "-n", str(path)], check=True)
    assert "NCCL" in text and "TPU" not in text and "ICI" not in text
    assert "python3 -m tethys_tpu_torch.scripts.job_name" in text
    assert "tcpdump host ${IP}" in text
    assert "${RESULT}/${MODEL}/${JOB}_${IP}_network.pcap" in text
