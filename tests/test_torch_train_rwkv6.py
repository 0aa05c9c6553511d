"""The training driver on the RWKV6 stack against the JAX reference, on
the CPU: ``--arch rwkv6-7b --scale 10m --device cpu`` over 2 rounds of 4
silos at S 32 against ``repro.launch.train.main`` from the reference's
parameters and explore uniforms (selected, received and ε identical, the
loss within 1e-4 relative).  Kept apart from
``tests/test_torch_train_recurrent.py`` (zamba2's run and both stacks'
gradients) so that each file runs in under a minute on one worker.
"""
from test_torch_train_recurrent import driver_matches_reference


def test_rwkv6_driver_matches_reference(monkeypatch):
    driver_matches_reference("rwkv6-7b", monkeypatch)
