"""Nothing the benchmark runs loads JAX, flax or the JAX package, and the
reference loads nothing of the program either.  Each check runs in a
fresh interpreter; module names are compared by their whole top-level
name (the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

from gpubench import harness

JAX_SIDE = {"jax", "jaxlib", "flax", "style_big_gan_tpu"}


def _loaded(code: str) -> set:
    p = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{harness.ROOT!r})\n{code}\nimport json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    """The reference, the FLOP counts and each configuration's family
    module (its faults import the program only when planted)."""
    top = _loaded("import gpubench.reference.training, "
                  "gpubench.reference.precision, gpubench.flops.stylegan2, "
                  "gpubench.datagen, gpubench.trace\n"
                  "from gpubench import harness\n"
                  "for c in harness.manifest()['configs']:\n"
                  "    harness.family(harness.config_of(c['name']))\n")
    assert not top & (JAX_SIDE | {"style_big_gan_tpu_torch"})


def test_the_harness_and_every_metric_reader_load_no_jax():
    code = ("from gpubench import harness, run, control, readings, faults\n"
            "for m in harness.manifest()['per_layer']:\n"
            "    harness.metric_reader(m['name'])\n")
    assert not _loaded(code) & JAX_SIDE


def test_a_whole_micro_run_loads_no_jax():
    code = ("from gpubench import harness\n"
            "from gpubench.tests.micro import micro\n"
            "c, t, o = micro('sg2ada.ada_p50')\n"
            "harness.run('sg2ada.ada_p50', 3, 0.1, False, device='cpu', "
            "config=c, traffic=t, extra_overrides=o, log=lambda s: None)\n"
            "assert not harness.forbidden_modules()\n")
    top = _loaded(code)
    assert "style_big_gan_tpu_torch" in top
    assert not top & JAX_SIDE


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["style_big_gan_tpu_torch.ops",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["jax.numpy", "style_big_gan_tpu.ops",
                                      "flax"]) == [
        "flax", "jax.numpy", "style_big_gan_tpu.ops"]
