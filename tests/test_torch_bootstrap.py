"""The port's process-group bootstrap and mesh (``parallel/bootstrap.py``).

Ported Labeled-LDA cases of ``tests/test_bootstrap.py``: the single-host
no-op, the mesh shapes over the ranks (four spawned gloo ranks; JAX: eight
fake devices) and the ``chains_for`` split, including the north star's
64 chains.  Also: the environment that ``torch.distributed.run`` sets and
the JAX package's are both read, the mesh's collectives sum and reduce over
the right ranks, ``entry.dryrun_multichip`` runs one sharded step on
four ranks, and ``launch.spawn`` computes on CUDA unless told otherwise,
as every entry point of the port does, with each job on its rank's device.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lda_thesis_tpu_torch.entry import dryrun_multichip
from lda_thesis_tpu_torch.parallel import (
    Mesh,
    chains_for,
    initialize_distributed,
    is_distributed,
)
from lda_thesis_tpu_torch.parallel.bootstrap import local_device, world
from lda_thesis_tpu_torch.parallel.launch import free_port, spawn

ROOT = Path(__file__).resolve().parents[1]
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
       "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


def test_initialize_distributed_single_host_noop(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed(device="cpu") is False  # nothing set: a no-op
    assert not is_distributed() and world() == (0, 1)
    assert initialize_distributed(device="cpu") is False  # and idempotent


def test_initialize_reads_the_environment():
    """``torch.distributed.run``'s variables, then the JAX package's, bring
    up a one-rank gloo group in a fresh interpreter."""
    code = (
        "import os\n"
        "from lda_thesis_tpu_torch.parallel.bootstrap import initialize_distributed, "
        "shutdown, world\n"
        "import torch.distributed as dist\n"
        "print(initialize_distributed(device='cpu'), world(), dist.get_backend())\n"
        "shutdown()\n"
        "for k in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):\n"
        "    os.environ.pop(k)\n"
        "os.environ.update(COORDINATOR_ADDRESS='localhost:%d', NUM_PROCESSES='1', "
        "PROCESS_ID='0')\n"
        "print(initialize_distributed(device='cpu'), world())\n"
        "shutdown()\n" % free_port())
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
               RANK="0", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [x for x in proc.stdout.splitlines() if not x.startswith("torch.distributed")]
    assert lines == ["True (0, 1) gloo", "True (0, 1)"]
    assert "torch.distributed: gloo backend, rank 0 of 1, device cpu" in proc.stdout


def test_make_global_mesh_shapes():
    res = spawn("lda_thesis_tpu_torch.parallel.jobs:mesh_job", 4,
                {"shapes": [(2, None), (4, 2), (1, 4), (3, None)]}, device="cpu",
                timeout=120)
    for rank, r in enumerate(res):
        two_by_two, bad_fill, one_by_four, three = r["meshes"]
        assert all(m.get("device", "cpu") == "cpu" for m in r["meshes"])
        assert two_by_two["shape"] == {"chains": 2, "data": 2}
        assert two_by_two["coords"] == divmod(rank, 2)
        row = rank // 2 * 2
        assert two_by_two["row_sum"] == 2 * row + 1 and two_by_two["row_max"] == row + 1
        assert two_by_two["world_sum"] == 6
        assert one_by_four["shape"] == {"chains": 1, "data": 4}
        assert one_by_four["row_sum"] == 6 and one_by_four["coords"] == (0, rank)
        assert "4x2 != 4 ranks" in bad_fill["error"]
        assert "not divisible by chains=3" in three["error"]


def test_chains_for_split():
    mesh = Mesh(8, 1, "cpu", rank=0, world_size=8)
    assert chains_for(64, mesh) == (8, 8)
    with pytest.raises(ValueError):
        chains_for(63, mesh)


def test_chains_for_64_on_a_two_by_two_mesh():
    """The north star's 64 chains on four ranks of a (2, 2) mesh: 32
    batched on each rank, their chain rows 0-31 and 32-63."""
    mesh = Mesh(2, 2, "cpu", rank=3, world_size=4)
    assert chains_for(64, mesh) == (2, 32) and mesh.coords == (1, 1)


def test_local_device_takes_no_fallback(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert local_device("cpu") == torch.device("cpu")
    assert local_device("cuda:0") == torch.device("cuda", 0)
    if not torch.cuda.is_available():
        assert local_device(None) == torch.device("cuda")  # no card: no CPU instead


def test_dryrun_multichip():
    out = dryrun_multichip(4, device="cpu", timeout=120)
    assert out["mesh"] == {"chains": 2, "data": 2} and out["backend"] == "gloo"
    assert out["s"] == 1 and out["tokens"] > 0
    # the sharded HSLDA loop: 3 cycles at thinning 2 fold in one save, and
    # both of the rank's chains hold every token of the corpus
    h = out["hslda"]
    assert h["chains"] == 2 and h["saves"] == 1
    assert len(h["tokens"]) == 2 and len(set(h["tokens"])) == 1 and h["tokens"][0] > 0


def test_spawn_and_jobs_default_to_cuda():
    """``spawn``'s device is CUDA unless named, as for
    ``entry.dryrun_multichip``, ``bootstrap.local_device`` and the models;
    a job whose payload names no device computes on the device its rank was
    brought up on (the CPU ranks of ``test_make_global_mesh_shapes``), and
    outside a process group on CUDA."""
    assert inspect.signature(spawn).parameters["device"].default is None
    assert inspect.signature(dryrun_multichip).parameters["device"].default is None
    assert not is_distributed() and local_device().type == "cuda"
