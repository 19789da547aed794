"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's file format and guards:

* the load guards of ``tests/test_checkpoint_integrity.py`` (treedef,
  dtype, truncation, writable leaves, meta-only read);
* for the same state and meta the port's file and the reference's are
  byte-identical, streamed or not, and a checkpoint written by either
  simulator restores into the other;
* interrupt + resume is bit-identical on both banks, and scheme, backend
  and cohort mismatches are refused;
* ``launch/serve --checkpoint`` serves the restored params.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.configs.paper_cnn import LIGHT_CONFIG as JCFG  # noqa: E402
from repro.core.simulator import FedSimulator as JSim  # noqa: E402
from repro.core.simulator import SimConfig as JSimConfig  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckmod  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    load_checkpoint_meta, save_checkpoint)
from repro_torch.configs.paper_cnn import LIGHT_CONFIG  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.core.simulator import FedSimulator, SimConfig  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

N, BATCH = 3, 4


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _data(seed, k=N):
    rng = np.random.RandomState(seed)
    return (rng.rand(k, 1, BATCH, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, (k, 1, BATCH)))


def _leaves(tree):
    return ckmod.tree_flatten(tree)[0]


def _kw(**kw):
    base = dict(scheme="sfl_ga", cut=2, n_clients=N, batch=BATCH,
                uplink_codec="int8", downlink_codec="int8", drift_metric=True)
    base.update(kw)
    return base


def _port(**kw):
    params = jax.tree.map(np.asarray, jcnn.init_cnn(jax.random.key(0), JCFG))
    return FedSimulator(LIGHT_CONFIG, SimConfig(**_kw(**kw)), device="cpu",
                        params=cnn_params_from_jax(params))


def _ref(**kw):
    return JSim(JCFG, JSimConfig(**_kw(**kw)), seed=0)


# ------------------------------------------------------------- load guards
class TestLoadGuards:
    def _save(self, tmp_path, tree):
        path = os.path.join(tmp_path, "ck.msgpack")
        save_checkpoint(path, tree, {"step": 1})
        return path

    def test_treedef_mismatch_raises(self, tmp_path):
        path = self._save(tmp_path, {"a": torch.ones(2), "b": torch.ones(2)})
        with pytest.raises(ValueError, match="treedef"):
            load_checkpoint(path, {"a": torch.ones(2), "c": torch.ones(2)})

    def test_dtype_mismatch_raises(self, tmp_path):
        path = self._save(tmp_path, {"a": torch.ones(2)})
        with pytest.raises(ValueError, match="dtype"):
            load_checkpoint(path, {"a": torch.ones(2, dtype=torch.bfloat16)})

    def test_truncated_payload_raises(self, tmp_path):
        path = self._save(tmp_path, {"a": torch.arange(64.0)})
        blob = _read(path)
        with open(path, "wb") as f:
            f.write(blob[:-8])
        with pytest.raises(ValueError, match="truncated"):
            load_checkpoint(path, {"a": torch.zeros(64)})

    def test_restored_leaves_are_writable(self, tmp_path):
        path = self._save(tmp_path, {"a": torch.ones(3)})
        tree, _ = load_checkpoint(path, {"a": torch.zeros(3)})
        tree["a"][0] = 5.0
        assert tree["a"][0] == 5.0

    def test_meta_only_read(self, tmp_path):
        path = self._save(tmp_path, {"a": torch.ones(2)})
        assert load_checkpoint_meta(path) == {"step": 1}


# --------------------------------------------------------- format parity
def _mixed():
    rng = np.random.RandomState(0)
    j = {"a": jnp.asarray(rng.randn(30, 30).astype(np.float32)),
         "h": np.arange(64, dtype=np.int8).reshape(8, 8),
         "l": [jnp.asarray(rng.randn(5).astype(np.float32)),
               (jnp.float32(3.5), jnp.zeros((2, 0), jnp.float32))],
         "bf": jnp.asarray(rng.randn(4, 3), jnp.bfloat16),
         "n": None}
    t = {"a": torch.from_numpy(np.array(j["a"])),
         "h": torch.from_numpy(j["h"]),
         "l": [torch.from_numpy(np.array(j["l"][0])),
               (torch.tensor(3.5), torch.zeros((2, 0)))],
         "bf": torch.from_numpy(np.asarray(j["bf"], np.float32)).to(
             torch.bfloat16),
         "n": None}
    return j, t


def test_file_bytes_equal_reference(tmp_path, monkeypatch):
    j, t = _mixed()
    meta = {"m": 1, "name": "x", "nested": {"k": [1, 2]}}
    pj, pt = tmp_path / "ref.ckpt", tmp_path / "port.ckpt"
    jsave(str(pj), j, meta)
    save_checkpoint(str(pt), t, meta)
    assert _read(pj) == _read(pt)
    monkeypatch.setattr(ckmod, "SAVE_CHUNK_BYTES", 64)  # streamed writer
    pc = tmp_path / "chunked.ckpt"
    save_checkpoint(str(pc), t, meta)
    assert _read(pc) == _read(pj)
    loaded, got_meta = load_checkpoint(str(pj), t)
    assert got_meta == meta
    for a, b in zip(_leaves(t), _leaves(loaded)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back, _ = jload(str(pt), jax.tree.map(np.asarray, j))
    for a, b in zip(jax.tree.leaves(j), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_simulator_files_equal_and_cross_restore(tmp_path):
    """The same state and meta give the same bytes from either simulator;
    the reference's file resumes in the port and the port's in the
    reference."""
    ref, port = _ref(), _port()
    pr, pp = tmp_path / "ref.ckpt", tmp_path / "port.ckpt"
    ref.save(str(pr)), port.save(str(pp))
    assert _read(pr) == _read(pp)

    ref.run_round(*_data(0))
    ref.save(str(pr))
    into_port = _port(cut=3)
    assert into_port.restore(str(pr))["t"] == 1 and into_port.cut == 2
    want = jax.tree.map(np.asarray, ref.state)
    for a, b in zip(jax.tree.leaves(want), _leaves(into_port.state)):
        np.testing.assert_array_equal(b.numpy(), a)
    into_port.run_round(*_data(1))
    into_port.save(str(pp))
    into_ref = _ref(cut=1)
    assert into_ref.restore(str(pp))["t"] == 2 and into_ref.cut == 2
    for a, b in zip(_leaves(into_port.state),
                    jax.tree.leaves(into_ref.state)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())


# ------------------------------------------------------------------ resume
@pytest.mark.parametrize("bank", ["device", "host"])
def test_resume_bit_identical_per_backend(tmp_path, bank):
    path = str(tmp_path / f"{bank}.ckpt")
    kw = dict(bank=bank, n_clients=5, cohort=2, sampler="uniform")
    whole, half = _port(**kw), _port(**kw)
    for i in range(4):
        data = _data(i, k=2)
        whole.run_round(*data)
        if i < 2:
            half.run_round(*data)
    half.save(path)
    assert load_checkpoint_meta(path)["bank_backend"] == bank
    resumed = _port(**kw)
    assert resumed.restore(path)["t"] == 2
    for i in range(2, 4):
        resumed.run_round(*_data(i, k=2))
    for a, b in zip(_leaves(whole.state), _leaves(resumed.state)):
        assert torch.equal(a, b)
    for sim in (whole, half, resumed):
        sim.close()


def test_mismatches_rejected(tmp_path):
    path = str(tmp_path / "host.ckpt")
    _port(bank="host").save(path)
    with pytest.raises(ValueError, match="bank backend"):
        _port(bank="device").restore(path)
    with pytest.raises(ValueError, match="scheme"):
        _port(scheme="psl").restore(path)
    path2 = str(tmp_path / "cohort.ckpt")
    _port(n_clients=5, cohort=2, sampler="uniform").save(path2)
    for kw in (dict(cohort=3), dict(sampler="rho"), dict(cohort_seed=1)):
        args = {**dict(n_clients=5, cohort=2, sampler="uniform"), **kw}
        with pytest.raises(ValueError, match="cohort schedule"):
            _port(**args).restore(path2)
    # a file without the backend field was device-resident
    src = _port()
    meta = {"t": 0, "cut": 2, "scheme": "sfl_ga", "n_clients": N}
    save_checkpoint(str(tmp_path / "old.ckpt"), src.state, meta)
    assert _port().restore(str(tmp_path / "old.ckpt"))["t"] == 0
    with pytest.raises(ValueError, match="bank backend"):
        _port(bank="host").restore(str(tmp_path / "old.ckpt"))


# -------------------------------------------------------------- launcher
def test_serve_checkpoint_matches_direct_params(tmp_path):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.serve_engine import ServeEngine, make_requests
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = reduced_config(get_config("granite-8b"))
    plan = lm.build_plan(cfg, 1)
    params = lm.init_lm(7, plan, torch.float32, "cpu")
    path = str(tmp_path / "lm.ckpt")
    save_checkpoint(path, params, {"step": 3})
    users, slots, prompt, gen = 3, 2, 8, 5
    served = serve.main(["--arch", "granite-8b", "--device", "cpu",
                         "--preset", "smoke", "--users", str(users),
                         "--slots", str(slots), "--prompt-len", str(prompt),
                         "--gen", str(gen), "--checkpoint", path,
                         "--quiet"])
    direct = ServeEngine(params, plan, slots=slots, max_len=prompt + gen,
                         page_size=16, codec="fp32", seed=0, device="cpu")
    for req in make_requests(users, prompt, gen, vocab_size=cfg.vocab_size,
                             seed=0):
        direct.submit(req)
    want = {c.uid: list(c.tokens) for c in direct.run()}
    got = {c.uid: list(c.tokens) for c in served.completions}
    assert got == want and len(got) == users
    seeded = serve.main(["--arch", "granite-8b", "--device", "cpu",
                         "--preset", "smoke", "--users", str(users),
                         "--slots", str(slots), "--prompt-len", str(prompt),
                         "--gen", str(gen), "--quiet"])
    assert {c.uid: list(c.tokens) for c in seeded.completions} != want
