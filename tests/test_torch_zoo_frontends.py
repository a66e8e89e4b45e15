"""whisper-large-v3 (``audio``) and phi-3-vision-4.2b (``vlm``): the
runtime's smoke train and decode against the reference on the CPU (the
bodies and what each holds: ``tests/_torch_zoo.py``,
``tests/test_torch_zoo.py``); their trainer and serving cases are in
``tests/test_torch_whisper.py`` and ``tests/test_torch_vlm.py``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_zoo as Z  # noqa: E402

ARCHS = ["whisper-large-v3", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_and_decode_matches_reference(arch):
    Z.check_smoke_train_and_decode(arch)
