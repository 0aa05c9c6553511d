"""The port's checkpointer (``repro_torch.checkpoint.checkpointer``)
against the JAX reference's (``repro.checkpoint.checkpointer``), on the
CPU.

* the bytes: a tree of every dtype the format writes (fp32, fp64, fp16,
  bf16, the integers, bool, a string leaf), 0-d and empty arrays, Python
  scalars, None, lists, tuples, a namedtuple, maps and sequences past
  msgpack's fix forms and arrays past bin8 and bin16, saved by both
  packages from the same values: identical files;
* restore in both directions, values and structure;
* the port's msgpack subset against every length form;
* a language model: the reference's ``flude-paper.reduced()`` parameters
  saved by JAX are byte-identical to the port's save of the same values
  (``convert.lm_params_to_jax``); ``repro_torch.launch.serve --ckpt``
  restores them into its per-layer tree and serves the ids the
  reference's serve loop gives on the same prompt; the reference's
  ``restore_like`` reads the port's file.
"""
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as RCK
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model

from repro_torch.checkpoint import checkpointer as CK
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch import serve as S
from repro_torch.models import build_model

from test_torch_serve import _reference_serve


class Moments(NamedTuple):
    mu: object
    count: object


def _values(rng):
    """numpy values of every kind the trees below hold."""
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "f64": rng.randn(4).astype(np.float64),
        "f16": rng.randn(2, 3).astype(np.float16),
        "bf16": rng.randn(7, 3).astype(np.float32),
        "i8": rng.randint(-128, 127, (5,)).astype(np.int8),
        "u8": rng.randint(0, 255, (6,)).astype(np.uint8),
        "i32": rng.randint(-2 ** 31, 2 ** 31 - 1, (3, 2)).astype(np.int32),
        "i64": rng.randint(-2 ** 62, 2 ** 62, (2,)).astype(np.int64),
        "bool": rng.rand(9) < 0.5,
        "scalar": np.float32(rng.randn()),
        "empty": np.zeros((0, 4), np.float32),
        "bin16": rng.randn(1000).astype(np.float32),      # 4000 bytes
        "bin32": rng.randn(20000).astype(np.float32),     # 80000 bytes
    }


def _tree(v, arr, bf16):
    """The same tree for either package: ``arr`` makes a leaf of a numpy
    array, ``bf16`` a bfloat16 leaf from fp32 values."""
    many = {f"key_{i:02d}": arr(np.full((1,), i, np.int32))
            for i in range(17)}                           # map16
    return {
        "arrays": {k: arr(x) for k, x in v.items() if k != "bf16"},
        "bf16": bf16(v["bf16"]),
        "nested": {"z": [arr(v["f32"]), None, (arr(v["i8"]), 3)],
                   "a": Moments(arr(v["f64"]), arr(v["i32"][0, 0])),
                   "m": many},
        "seq": [arr(np.int32(i)) for i in range(20)],      # array16
        "python": {"int": 7, "neg": -40, "float": 2.5, "true": True},
        "a_key_longer_than_thirty_one_characters": arr(v["u8"]),
        "text": "abc",
        "none": None,
    }


def _jax_tree(v):
    # numpy leaves (jnp would narrow int64 and float64 without x64), a
    # jax bfloat16 one
    return _tree(v, np.array, lambda x: jnp.asarray(x, jnp.bfloat16))


def _port_tree(v):
    return _tree(v, lambda x: torch.from_numpy(np.array(x)),
                 lambda x: torch.from_numpy(x).to(torch.bfloat16))


def test_saved_bytes_equal_the_reference(tmp_path):
    v = _values(np.random.RandomState(0))
    RCK.save(str(tmp_path / "ref.ck"), _jax_tree(v))
    CK.save(str(tmp_path / "port.ck"), _port_tree(v))
    want = (tmp_path / "ref.ck").read_bytes()
    got = (tmp_path / "port.ck").read_bytes()
    assert len(got) == len(want) and got == want
    assert not (tmp_path / "port.ck.tmp").exists()


def _same(got, want):
    """A port-restored leaf (tensor, or numpy for a string) against a
    reference-restored one (numpy)."""
    if isinstance(got, torch.Tensor):
        if got.dtype == torch.bfloat16:
            got = got.float().numpy()
            want = np.asarray(want, np.float32)
        else:
            got = got.numpy()
    assert got.shape == np.shape(want)
    assert got.dtype == np.asarray(want).dtype
    assert np.array_equal(got, np.asarray(want))


def test_restore_in_both_directions(tmp_path):
    v = _values(np.random.RandomState(1))
    RCK.save(str(tmp_path / "ref.ck"), _jax_tree(v))
    CK.save(str(tmp_path / "port.ck"), _port_tree(v))
    for path in ("ref.ck", "port.ck"):
        got = CK.restore(str(tmp_path / path))
        want = RCK.restore(str(tmp_path / path))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            _same(g, w)
        assert got["bf16"].dtype == torch.bfloat16
        assert got["nested"]["a"] == {"mu": got["nested"]["a"]["mu"],
                                      "count": got["nested"]["a"]["count"]}
        assert isinstance(got["nested"]["z"][2], tuple)
        assert got["none"] is None and got["text"].dtype.kind == "U"


def test_restore_like_rewraps_and_casts(tmp_path):
    v = _values(np.random.RandomState(2))
    tree = _port_tree(v)
    CK.save(str(tmp_path / "port.ck"), tree)
    like = dict(tree)
    like["arrays"] = dict(tree["arrays"], f32=tree["arrays"]["f32"].double())
    got = CK.restore_like(str(tmp_path / "port.ck"), like)
    assert isinstance(got["nested"]["a"], Moments)
    assert got["arrays"]["f32"].dtype == torch.float64
    assert torch.equal(got["arrays"]["f32"].float(), tree["arrays"]["f32"])
    assert torch.equal(got["bf16"], tree["bf16"])
    bad = dict(tree, arrays=dict(tree["arrays"], f32=torch.zeros(5, 3)))
    with pytest.raises(ValueError, match="shape"):
        CK.restore_like(str(tmp_path / "port.ck"), bad)


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.1, -2.5e300, True, False, None, "", "x" * 31, "x" * 32,
    "x" * 255, "x" * 256, "x" * 65536, "ü", b"", b"\x00" * 255,
    b"\x01" * 256, b"\x02" * 65536, [], list(range(15)), list(range(16)),
    list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {"a": [1, {"b": None}]},
], ids=lambda o: type(o).__name__ + str(len(o) if hasattr(o, "__len__")
                                         else o)[:12])
def test_msgpack_subset_matches_msgpack(obj):
    msgpack = pytest.importorskip("msgpack")
    want = msgpack.packb(obj, use_bin_type=True)
    assert CK.packb(obj) == want
    assert CK.unpackb(want) == msgpack.unpackb(want, raw=False,
                                               strict_map_key=False)


def test_lm_checkpoint_crosses_packages_and_serves(tmp_path, capsys):
    rcfg = ref_get_config("flude-paper").reduced()
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.key(4))
    ref_path, port_path = str(tmp_path / "ref.ck"), str(tmp_path / "port.ck")
    RCK.save(ref_path, rparams)
    params = lm_params_from_jax(jax.tree.map(np.asarray, rparams),
                                rcfg.num_layers)
    CK.save(port_path, lm_params_to_jax(params))
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()

    # the port's serve entry point restores the reference's file
    B, Sq, N = 2, 24, 6
    res = S.main(["--arch", "flude-paper", "--reduced", "--device", "cpu",
                  "--ckpt", ref_path, "--batch", str(B), "--prompt-len",
                  str(Sq), "--decode-tokens", str(N), "--seed", "9"])
    # its prompt: main's generator, seeded seed + 1
    tokens = torch.randint(0, rcfg.vocab_size, (B, Sq),
                           generator=torch.Generator().manual_seed(10))
    restored = RCK.restore_like(port_path, rparams)
    want_ids, want_logits = _reference_serve(
        ref, restored, jnp.asarray(tokens.numpy().astype(np.int32)), N)
    np.testing.assert_array_equal(res.ids.numpy(), want_ids)
    np.testing.assert_allclose(res.logits.numpy(), want_logits, rtol=1e-4,
                               atol=1e-4)
    assert "serving flude-paper-reduced" in capsys.readouterr().out

    model = build_model(get_config("flude-paper").reduced())
    like = model.init(torch.Generator().manual_seed(0))
    got = CK.restore_like(ref_path, like)
    assert isinstance(got["blocks"], list) and len(got["blocks"]) == 2
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert torch.equal(a, b)


def test_serve_ckpt_of_a_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        S.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                "--ckpt", os.path.join("nonexistent", "ck.msgpack")])
