"""What a run loads: the port and the harness, never JAX or the JAX
package, compared by whole top-level names."""
import subprocess
import sys
import textwrap

from ngbench.tests.conftest import ROOT


def test_no_jax_nor_the_jax_package_is_loaded():
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        from ngbench import bench, control, counts, program, readers, \\
            scenes, spec, trace
        from ngbench.reference import field, render
        for name in spec.per_layer("nerf_hash.frames_720p_culled"):
            pass
        for name in spec.per_layer("nerf_hash.train_32k_rays"):
            pass
        for w in spec.benchmark()["workloads"]:
            cell = spec.find_cell(w["name"])
            spec.generator(cell), spec.kind(cell), spec.app(cell)
        print(",".join(bench.forbidden_modules()))
        print("repro_torch" in sys.modules)
    """ % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.split("\n")
    assert out[0] == ""
    assert out[1] == "True"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from ngbench import bench
    for name in ("jaxtyping", "repro_torch.core", "reprox", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in bench.forbidden_modules()
                if m.split(".")[0] in ("jaxtyping", "repro_torch", "reprox",
                                       "flaxen")]
    for name in ("jax", "jax.numpy", "repro.core.fields", "flax", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = bench.forbidden_modules()
    for name in ("jax", "jax.numpy", "repro.core.fields", "flax", "jaxlib"):
        assert name in found
