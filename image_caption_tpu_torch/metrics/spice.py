"""SPICE via the coco-caption Java jar (gated; the reference ships it
commented out, evaluations.py:19).

Enabled by ``$ICX_SPICE_JAR`` -> ``spice-1.0.jar``; otherwise
``compute_score`` raises ``SpiceUnavailable``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
from typing import Dict

import numpy as np


class SpiceUnavailable(RuntimeError):
    pass


class Spice:
    def compute_score(self, gts: Dict, res: Dict):
        jar = os.environ.get("ICX_SPICE_JAR", "")
        if not jar or not os.path.exists(jar):
            raise SpiceUnavailable(
                "SPICE jar not found: set $ICX_SPICE_JAR to spice-1.0.jar")
        if shutil.which("java") is None:
            raise SpiceUnavailable("java not on PATH")

        assert sorted(gts.keys()) == sorted(res.keys())
        payload = [{"image_id": key, "test": res[key][0], "refs": gts[key]}
                   for key in sorted(gts.keys())]
        with tempfile.TemporaryDirectory() as tmp:
            in_path = os.path.join(tmp, "in.json")
            out_path = os.path.join(tmp, "out.json")
            with open(in_path, "w") as f:
                json.dump(payload, f)
            subprocess.check_call(
                ["java", "-jar", "-Xmx8G", jar, in_path, "-cache",
                 os.path.join(tmp, "cache"), "-out", out_path, "-subset",
                 "-silent"],
                cwd=os.path.dirname(os.path.abspath(jar)))
            with open(out_path) as f:
                results = json.load(f)
        by_id = {item["image_id"]: item["scores"]["All"]["f"]
                 for item in results}
        scores = [float(by_id[key]) for key in sorted(gts.keys())]
        return float(np.mean(scores)), scores

    def method(self) -> str:
        return "SPICE"
