"""Run one of the JAX package's visualisation tools and record what it predicts.

``python -m tests.fixtures.jax_visual TOOL OUT SEED -- ARGV...`` runs
``tools/visual/TOOL.py`` with ``ARGV`` as its command line, in this
interpreter, after registering the fixtures' reduced HRNet in the JAX
package's registry and seeding numpy's global stream with ``SEED`` (the
train loader's augmentations draw from it). The top-down tool's jitted
forward and the AE tool's inferencer are wrapped so that each sample's
outputs are kept: the decoded keypoints and the heatmap (top-down), the
inferencer's record (AE). They are pickled to ``OUT``. This module imports
JAX; tests/test_torch_visual.py starts it with ``JAX_PLATFORMS=cpu``.
"""
import os
import pickle
import runpy
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _record_topdown(records):
    import jax

    jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        compiled = jit(fn, *args, **kwargs)

        def call(*a, **kw):
            out = compiled(*a, **kw)
            (preds, _), heatmap = out
            records.append({"preds": np.asarray(preds)[0], "heatmap": np.asarray(heatmap)[0]})
            return out

        return call

    jax.jit = recording_jit


def _record_ae(records):
    import mindpose_tpu.engine as engine

    create = engine.create_inferencer

    def recording_create(*args, **kwargs):
        inferencer = create(*args, **kwargs)

        def call(dataset, variables=None):
            out = inferencer(dataset, variables=variables)
            records.append({"pred": [np.asarray(p) for p in out[0]["pred"]],
                            "score": [float(s) for s in out[0]["score"]]})
            return out

        return call

    engine.create_inferencer = recording_create


def main() -> None:
    tool, out_path, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
    argv = sys.argv[sys.argv.index("--") + 1:]
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from tests import make_torch_eval_fixture as fixture

    fixture.register_jax_backbone()
    records = []
    if tool == "visual_pred_heatmap_topdown":
        _record_topdown(records)
    elif tool == "visual_pred_heatmap_ae":
        _record_ae(records)
    path = os.path.join(ROOT, "tools", "visual", f"{tool}.py")
    sys.argv = [path, *argv]
    np.random.seed(seed)
    runpy.run_path(path, run_name="__main__")
    with open(out_path, "wb") as f:
        pickle.dump(records, f)


if __name__ == "__main__":
    main()
