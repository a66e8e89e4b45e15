"""qwen2.5-3b (GQA 16/2, QKV bias, rope theta 1e6): the runtime's smoke
train and decode, the eager trainer and the serving engine against the
reference on the CPU (the bodies and what each holds:
``tests/_torch_zoo.py``, ``tests/test_torch_zoo.py``)."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_zoo as Z  # noqa: E402

ARCHS = ["qwen2.5-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_and_decode_matches_reference(arch):
    Z.check_smoke_train_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_eager_trainer_matches_reference(arch):
    Z.check_eager_trainer(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_matches_reference(arch):
    Z.check_serving_engine(arch)
