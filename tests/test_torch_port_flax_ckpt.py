"""The port's flax checkpoint codec (io/flax_ckpt.py, no flax, no msgpack)
against flax.serialization, and the GenericUNet weight bridge both ways.

- `loads` must give what `flax.serialization.msgpack_restore` gives, bit for
  bit: on a JAX trainer's `save_checkpoint` file with its optax state, on a
  full-width flagship params tree (shapes from `jax.eval_shape` of the init
  at the 96x192x192 patch, leaves seeded numpy: the init itself is not run
  on the CPU), and on a bfloat16 leaf, numpy scalars and chunked arrays
  (flax's MAX_CHUNK_SIZE made small);
- `dumps` must give `flax.serialization.to_bytes`' bytes exactly;
- io/torch_convert.convert_generic_unet_state_dict (state dict -> flax tree)
  must equal the JAX package's and undo io/from_jax.py, bit-exactly.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from multitalent_tpu.io.torch_convert import convert_generic_unet_state_dict as jax_convert
from multitalent_tpu.models.generic_unet import build_unet_from_plans as jax_build
from multitalent_tpu.plans import Plans
from multitalent_tpu.training.trainers import TrainerV2 as JaxTrainerV2
from multitalent_tpu_torch.io import flax_ckpt
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.io.torch_convert import convert_generic_unet_state_dict
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans

from test_torch_port_selfcontained import _plans_dict
from test_torch_port_train_slice import flagship_like_plans, port_plans


def assert_bits_equal(got, ref, path="") -> None:
    """Same keys in the same order, leaves of the same type, dtype, shape and
    bytes (bfloat16: the port's torch.bfloat16 against numpy's, by bits)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            assert_bits_equal(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == ref.shape, path
        assert np.array_equal(got.view(torch.uint16).numpy(),
                              np.asarray(ref).view(np.uint16)), path
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, path
        assert got.shape == ref.shape and got.tobytes() == ref.tobytes(), path
    else:
        assert type(got) is type(ref) and (got == ref or (got != got and ref != ref)), path


def _seeded(shapes, rng):
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def trainer_ckpt(tmp_path_factory):
    """A JAX TrainerV2's save_checkpoint file (step, params, SGD trace)
    after the optimizer state was filled with seeded values."""
    path = tmp_path_factory.mktemp("ckpt") / "model_final_checkpoint.ckpt"
    t = JaxTrainerV2(flagship_like_plans(), 0, None, None, fp16=False)
    t.initialize(False)
    rng = np.random.default_rng(0)
    t.state = t.state.replace(
        step=jnp.asarray(7, jnp.int32),
        opt_state=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype) if x.ndim else x,
            t.state.opt_state))
    t.save_checkpoint(str(path))
    return path, t


def test_reader_matches_flax_on_a_trainer_checkpoint(trainer_ckpt):
    path, _ = trainer_ckpt
    data = path.read_bytes()
    got, ref = flax_ckpt.load(str(path)), serialization.msgpack_restore(data)
    assert set(ref) == {"step", "params", "opt_state"}
    assert_bits_equal(got, ref)


def test_writer_matches_to_bytes_on_a_trainer_state(trainer_ckpt):
    path, t = trainer_ckpt
    tree = jax.device_get(t.state_pytree())
    assert flax_ckpt.dumps(serialization.to_state_dict(tree)) == path.read_bytes()


@pytest.fixture(scope="module")
def flagship_tree():
    """{"step", "params"} of the full-width flagship GenericUNet (base 30,
    47 heads), params seeded from jax.eval_shape's shapes."""
    net = jax_build(Plans.from_dict(_plans_dict()), 0, num_classes=47, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 192, 192, 1), jnp.float32))["params"]
    params = _seeded(shapes, np.random.default_rng(1))
    port = build_unet_from_plans(port_plans(Plans.from_dict(_plans_dict())), 0, num_classes=47)
    n = sum(v.size for v in jax.tree_util.tree_leaves(params))
    assert n == sum(p.numel() for p in port.parameters()) > 29e6
    return {"step": np.asarray(250000, np.int32), "params": params}


def test_reader_and_writer_match_flax_at_flagship_width(flagship_tree):
    data = serialization.to_bytes(flagship_tree)
    assert flax_ckpt.dumps(flagship_tree) == data
    assert_bits_equal(flax_ckpt.loads(data), serialization.msgpack_restore(data))


def _special_tree(rng):
    return {"params": {"w_bf16": np.asarray(rng.standard_normal((3, 5)), ml_dtypes.bfloat16),
                       "w_f64": rng.standard_normal(4),
                       "i8": np.arange(-3, 3, dtype=np.int8),
                       "u32": np.arange(6, dtype=np.uint32).reshape(2, 3),
                       "flag": np.array([True, False]),
                       "empty": np.zeros((0, 4), np.float32),
                       "scalar_f32": np.float32(1.5), "scalar_i64": np.int64(-40000),
                       "scalar_f64": np.float64(-2.25), "scalar_bool": np.bool_(True)},
            "meta": {"ints": [0, 127, 128, -32, -33, 255, 256, 65536, -2 ** 31 - 1, 2 ** 40],
                     "floats": (0.5, -1e300), "name": "x" * 40, "long": "y" * 300,
                     "none": None, "yes": True, "raw": b"\x00\x01" * 200},
            "many": {f"k{i}": np.full((i % 3 + 1,), i, np.int16) for i in range(40)}}


@pytest.mark.parametrize("chunk", [None, 24])
def test_special_leaves_and_chunks_match_flax(monkeypatch, chunk):
    """bfloat16 leaves, numpy scalars of several types, python scalars,
    long strings and maps, and (chunk=24) every array over 24 bytes cut into
    flax's chunked form."""
    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_ckpt, "MAX_CHUNK_SIZE", chunk)
    tree = _special_tree(np.random.default_rng(2))
    data = serialization.to_bytes(tree)
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in data
    assert flax_ckpt.dumps(tree) == data
    assert_bits_equal(flax_ckpt.loads(data), serialization.msgpack_restore(data))


def test_reader_refuses_what_flax_does_not_write():
    with pytest.raises(ValueError, match="truncated"):
        flax_ckpt.loads(serialization.to_bytes({"a": np.ones(3)})[:-2])
    with pytest.raises(ValueError, match="ext type 5"):
        flax_ckpt.loads(b"\x81\xa1a\xd4\x05\x00")


def test_weight_bridge_round_trips_bit_exactly():
    """state dict -> flax tree equals the JAX package's conversion, and
    io/from_jax.py brings it back bit-equal; a flax tree goes round the
    other way bit-equal too."""
    plans = port_plans(flagship_like_plans())
    torch.manual_seed(0)
    sd = build_unet_from_plans(plans, 0, num_classes=47).state_dict()
    tree = convert_generic_unet_state_dict(sd, num_pool=3)
    assert_bits_equal(tree, jax_convert(sd, num_pool=3))
    back = generic_unet_state_dict_from_flax(tree, num_pool=3)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    again = convert_generic_unet_state_dict(back, num_pool=3)
    assert_bits_equal(again, tree)
