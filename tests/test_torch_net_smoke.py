"""chip_smoke.py's `net`, `net_fused`, `net_rollback`, `net_train` and
`net_gen` phases at a tiny size on the CPU: the same code the card runs,
cut (t4_30e for 2 epochs of 3 batches; an LM of 2 layers at width 32; a
tiny_transformer of width 16), with every check of the phase in force
but the held-out gate, which a cut run does not reach, and those that
need the card (graph captures, the profiler's kernel counts)."""
import pytest

import chip_smoke as cs

from tests.test_torch_threads import one_torch_thread  # noqa: F401

TINY_LM = dict(batch=2, vocab=16, dim=32, heads=4, layers=2, rope=True)
TINY_WORDS = ("2 16 1 1 nn.model 32 16 nn.embed\n"
              + "layernorm 3 4 nn.attn tanh\n" * 2
              + "layernorm 16 nn.proj softmax constant lm")


@pytest.fixture(autouse=True)
def no_batch_cut(monkeypatch):
    """phase_net sets T4_MAX_BATCH for its cut; it is put back after"""
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)


def test_net_phase_runs_cut_on_the_cpu(capsys):
    cs.phase_net(device="cpu", epochs=2, max_batch=3, profile_batches=2)
    out = capsys.readouterr().out
    assert "net: cut to 2 epochs of 20, T4_MAX_BATCH=3" in out
    assert '"saved_model_weights_equal": true' in out
    assert '"saved_model_same_class_share_cpu": 1.0' in out


def test_net_fused_phase_matches_its_control_on_the_cpu(capsys):
    """the default path's first epochs print the per-word control's
    lines, and the fused cycle and the chunks ran"""
    control = cs.phase_net(device="cpu", epochs=2, max_batch=5,
                           profile_batches=2)
    assert len(control) == 2
    cs.phase_net_fused(device="cpu", epochs=2, max_batch=5,
                       profile_batches=2, control=control)
    out = capsys.readouterr().out
    assert "net_fused: cut to 2 epochs of 20, T4_MAX_BATCH=5" in out
    assert '"first_epochs_equal_control": true' in out
    assert '"fused_cycles_and_chunks_ran": true' in out


def test_net_rollback_phase_runs_on_the_cpu(capsys):
    cs.phase_net_rollback(device="cpu", batches=6, chunk=3)
    out = capsys.readouterr().out
    for check in ("probe_weights_equal", "macro_served",
                  "nan_lazy_same_batch", "nan_eager_weights_equal"):
        assert f'"{check}": true' in out


def test_net_train_phase_runs_tiny_on_the_cpu(capsys):
    ran = cs.phase_net_train(device="cpu", lm=dict(
        batch=2, seq=8, dim=16, heads=4, classes=4, layers=2), n_batches=3,
        epochs=2, max_batch=3)
    out = capsys.readouterr().out
    assert '"nn_train_equals_word_loop": true' in out
    assert '"nn_train_ran": true' in out
    # on the CPU the wrappers take the plain versions: nothing launches
    assert not any(ran.values())


def test_net_gen_phase_runs_tiny_on_the_cpu(capsys):
    ran = cs.phase_net_gen(0, device="cpu", lm=TINY_LM, n_prompt=16,
                           n_new=4, words=TINY_WORDS)
    out = capsys.readouterr().out
    assert '"tokens_equal_generate": true' in out
    assert '"replay_tokens": true' in out
    # on the CPU the wrappers take the plain versions: nothing launches
    assert not any(ran.values())
