"""The CPU dry run of ``chip_smoke.py``'s phase 37 (the analysis tools).

In a fresh interpreter, with ``smoke_data/`` moved to a temporary
directory, the children that phase 37 reads run as phases 27 and 29 (d)
start them, with ``chip_smoke._witness_env`` in their environment only: a
2-process gang fit on the CPU (``fit_process_group``, as phase 27's
card-against-CPU gangs) and a ``ReplicaSupervisor`` of one replica
process. Then ``phase_analysis`` lints the port's tree and checks their
dumps against its static lock graph; a dump with a site outside that
graph must fail the witness part. This process itself stays unwitnessed.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRY_RUN = r'''
import json, os, sys, urllib.request
import numpy as np
import chip_smoke as cs
from mmlspark_tpu_torch.analysis.witness import active_witness
from mmlspark_tpu_torch.lightgbm import procfit, train
from mmlspark_tpu_torch.ops import hopper_histogram as hh
from mmlspark_tpu_torch.ops import u_histogram as uh
from mmlspark_tpu_torch.serving import ReplicaSupervisor

tmp = sys.argv[1]
cs.DATA_DIR = tmp
cs.WITNESS_DIR = os.path.join(tmp, "lockwitness")
rng = np.random.default_rng(0)
X = rng.normal(size=(2000, 5))
y = (X[:, 0] > 0).astype(float)
procfit.fit_process_group(X, y, train.TrainOptions(num_iterations=3, num_leaves=7),
                          num_processes=2, device="cpu", workdir=os.path.join(tmp, "gang"),
                          group_options={"env": cs._witness_env(os.environ, "gang")})
sup = ReplicaSupervisor("mmlspark_tpu_torch.serving.replicas:demo_model_factory",
                        num_replicas=1, workdir=os.path.join(tmp, "replicas"), seed=3,
                        ready_timeout_s=60.0,
                        env=cs._witness_env(dict(os.environ), "replicas"))
with sup:
    req = urllib.request.Request(sup.urls()[0], data=json.dumps({"input": 4.0}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read()) == {"prediction": 8.0}
assert active_witness() is None
rec = cs.phase_analysis(uh, hh, "NVIDIA H100 80GB HBM3, 700.00 W")
bad = os.path.join(cs.WITNESS_DIR, "replicas", "lockwitness-1.json")
with open(bad, "w") as fh:
    json.dump({"version": 1, "sites": {"mmlspark_tpu_torch/serving/none.py:1": "lock"},
               "edges": []}, fh)
try:
    cs._analysis_witness(cs._analysis_lint({}), {})
except AssertionError as e:
    rec["bad_dump"] = str(e)
print("RESULT " + json.dumps(rec))
'''


def test_chip_smoke_analysis_phase_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("MMLSPARK_TPU_LOCKCHECK", None)
    proc = subprocess.run([sys.executable, "-c", DRY_RUN, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rec = json.loads(proc.stdout.split("RESULT ", 1)[1])
    lint = rec["lint"]
    assert lint["violations"] == lint["stale_suppressions"] == lint["parse_errors"] == 0
    assert lint["sarif_results"] == 0 and lint["rules"] == 13 and lint["files"] > 150
    assert (tmp_path / "graftlint.sarif").exists()
    witness = rec["witness"]
    assert witness["gang"]["dumps"] == 2 and witness["replicas"]["dumps"] == 1
    assert witness["gang"]["sites"] > 0 and witness["replicas"]["sites"] > 0
    assert witness["lock_witness_findings"] == 0
    assert "mmlspark_tpu_torch/serving/none.py:1" in rec["bad_dump"]
