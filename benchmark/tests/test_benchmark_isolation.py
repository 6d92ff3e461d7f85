"""Nothing the benchmark runs imports ``jax`` or ``paragraph_tpu``: a
pipelined job (spawned workers) of the harness on the port's plain CPU
fill, with both made unimportable in the parent and, through a
``sitecustomize`` on PYTHONPATH, in every process it starts; then no
loaded module's top-level name, whole, is either."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SITE = textwrap.dedent('''
    import os, sys

    class _Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                      "paragraph_tpu"):
                with open(os.environ["BENCH_TEST_REFUSED"], "a") as f:
                    f.write(f"{os.getpid()} {name}\\n")
                raise ImportError(f"refused in the isolation test: {name}")
            return None

    sys.meta_path.insert(0, _Refuse())
''')

DRIVE = textwrap.dedent('''
    import json, sys
    import torch
    torch.set_num_threads(1)
    from benchmark.run import forbidden_modules, run_cell
    from benchmark.tests.helpers import SEED, fixture_cell

    if __name__ == "__main__":
        out = run_cell(fixture_cell("tiny.pipelined"), SEED, 0.1, False,
                       device="cpu")
        stages = out["record"]["jobs"][0]["stage_s"]
        print(json.dumps({"correct": out["result"]["correct"],
                          "pipelined": "extract_wait" in stages,
                          "forbidden": forbidden_modules()}))
''')


def test_no_jax_anywhere(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITE)
    refused = tmp_path / "refused.txt"
    refused.write_text("")
    script = tmp_path / "drive.py"
    script.write_text(DRIVE)
    env = dict(os.environ, BENCH_TEST_REFUSED=str(refused),
               PYTHONPATH=os.pathsep.join([str(site), ROOT]))
    p = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "pipelined": True, "forbidden": []}
    assert refused.read_text() == ""
