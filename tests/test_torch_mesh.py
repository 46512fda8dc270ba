"""The port's data-parallel mesh (gagan_tpu_torch/parallel/mesh.py) and its
dry runs: each rank's share of the batch against JAX's, the replica check,
the refusals that come before any process group (NCCL with two ranks on
one card, more ranks than cards), the process-stable noise fold, the
``basic`` and resume protocols (tools/dryrun_multiprocess.py's) and
``entry.dryrun_multichip`` over two gloo ranks on the CPU.  Every spawn has
a 120 s limit on each collective and on the whole run."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.parallel import create_mesh as jcreate_mesh
from gagan_tpu.parallel import shard_batch as jshard_batch
from gagan_tpu_torch import entry
from gagan_tpu_torch.cli import train as ttrain
from gagan_tpu_torch.parallel import dryrun
from gagan_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _meshes(world):
    return [tmesh.Mesh(world, r, torch.device("cpu")) for r in range(world)]


def test_shard_batch_is_jaxs_share():
    """One round: each rank's rows are the block that JAX's shard_batch
    puts on the mesh's device of that index."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    (jx,) = jshard_batch(jcreate_mesh(2), (jnp.asarray(x),))
    want = {s.device: np.asarray(s.data) for s in jx.addressable_shards}
    devices = list(jcreate_mesh(2).devices.flat)
    for mesh in _meshes(2):
        got = tmesh.shard_batch(mesh, torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want[devices[mesh.rank]])


@pytest.mark.parametrize("rounds,world", [(1, 2), (2, 2), (4, 2), (2, 4)])
def test_shard_batch_rounds_concatenate_to_the_global_batch(rounds, world):
    """With accumulation rounds a rank holds its block of every round's
    chunk: round by round, the ranks' chunks concatenate to the global
    round (JAX's ``_chunk`` of the global batch, then the mesh split)."""
    n = 16
    x = torch.arange(n * 2.0).reshape(n, 2)
    shares = [tmesh.shard_batch(m, {"x": x, "none": None}, rounds)
              for m in _meshes(world)]
    assert all(s["none"] is None for s in shares)
    chunk = n // rounds
    for r in range(rounds):
        got = torch.cat([s["x"][r * chunk // world:(r + 1) * chunk // world]
                         for s in shares])
        assert torch.equal(got, x[r * chunk:(r + 1) * chunk])
    with pytest.raises(ValueError, match="multiple of"):
        tmesh.share_rows(6, 4, 0)


def test_world_of_one_is_the_plain_step():
    """Outside a process group the mesh is a world of one whose
    collectives are the identity, and the bound step is the plain one."""
    mesh = tmesh.create_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.sharded) == (1, 0, False)
    t = torch.arange(3.0)
    assert torch.equal(mesh.all_reduce_(t.clone()), t)
    assert torch.equal(mesh.gather(t[1:], [1, 2], 3), torch.tensor(
        [0.0, 1.0, 2.0]))
    tmesh.check_replica_consistency({"a": t})      # no group: nothing to do
    case = dryrun._protocol_case(1)
    steps, state, inputs = case.build(None, "cpu")
    a, _ = steps["both"](state, *inputs)
    steps2, state2, inputs2 = case.build(mesh)
    b, _ = steps2["both"](state2, *inputs2)
    assert dryrun.state_digest(a) == dryrun.state_digest(b)
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.create_mesh(2, device="cpu")


@pytest.fixture(scope="module")
def protocols():
    """One run of two gloo ranks through ``python -m
    gagan_tpu_torch.parallel.dryrun``'s protocols."""
    return dryrun.main(["--ranks", "2", "--device", "cpu", "--timeout",
                        str(TIMEOUT)])


def test_check_replica_consistency_names_the_leaf(protocols):
    """A leaf changed on rank 1 alone: every rank raises, naming it."""
    msgs = [r["replica"] for r in protocols]
    assert msgs[0] == msgs[1]
    assert "tree.b/c" in msgs[0] and "ranks 0 and 1" in msgs[0]


def test_nccl_refuses_two_ranks_on_one_card():
    """Refused before any process is started or group made: NCCL cannot
    put two ranks on one card; the message names gloo."""
    with pytest.raises(ValueError, match="gloo"):
        tmesh.spawn(dryrun.multichip_rank, 2, backend="nccl",
                    devices="cuda:0")
    with pytest.raises(ValueError, match="CUDA"):
        tmesh.resolve_backend("nccl", [torch.device("cpu")] * 2)
    assert tmesh.resolve_backend(None, [torch.device("cpu")] * 2) == "gloo"
    assert tmesh.resolve_backend("gloo", [torch.device("cuda", 0)] * 2) == (
        "gloo")


def test_more_ranks_than_cards_is_refused(tmp_path, capsys):
    visible = torch.cuda.device_count()
    n = max(visible, 1) + 1
    with pytest.raises(ValueError, match=f"{n} cards.*{visible} CUDA"):
        ttrain.world_size(n, "cuda")
    with pytest.raises((ValueError, RuntimeError), match="CUDA"):
        tmesh.rank_devices(n)
    assert ttrain.world_size(3, "cpu") == 3


_FOLD = ("import sys; sys.path.insert(0, {repo!r})\n"
         "from gagan_tpu_torch.utils.rng import Rng, name_fold\n"
         "names = ['b4.conv1', 'b8.conv0', 'b1024.conv1', 'b64.torgb']\n"
         "print(([name_fold(n) for n in names], "
         "[Rng(7).fold_in(name_fold(n)).normal((2,)).tolist() "
         "for n in names]))")


def test_noise_fold_is_process_stable():
    """The layer-noise keys fold a CRC of the layer name, so interpreters
    with other hash salts draw the same noise (the counterpart of
    tests/test_multiprocess.py's check: salted ``hash`` made JAX's ranks
    diverge), and the fold is JAX's ``_name_fold``."""
    outs = []
    for seed in ("0", "12345"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        out = subprocess.run([sys.executable, "-c", _FOLD.format(repo=REPO)],
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout.strip())
    assert outs[0] == outs[1]
    folds = eval(outs[0])[0]
    assert folds == [jsg._name_fold(n) for n in
                     ["b4.conv1", "b8.conv0", "b1024.conv1", "b64.torgb"]]


def test_basic_and_resume_protocols(protocols):
    """tools/dryrun_multiprocess.py's protocols on two gloo ranks: the
    ranks agree bit for bit after two steps, a Collector reduced across
    them reads the global moments, only rank 0 writes the snapshot; and
    four steps equal two, a save by rank 0, a restore on every rank and
    two more, bit for bit."""
    dryrun.check_protocols(protocols)
    basic = [r["basic"] for r in protocols]
    assert [r["wrote_snapshot"] for r in basic] == [True, False]
    assert all(r["resume"]["resume"]["cur_nimg"] == 16 for r in protocols)


def test_dryrun_multichip_over_two_ranks():
    metrics = entry.dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    assert {"Loss/G/loss", "Loss/D/loss", "Loss/pl_penalty",
            "Loss/r1_penalty"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
