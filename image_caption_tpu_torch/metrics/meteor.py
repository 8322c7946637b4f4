"""METEOR — jar-exact when Java is available, in-process otherwise.

The reference scores METEOR through coco-caption's Java subprocess
(evaluations.py:8,16; Dockerfile:15-18 installs OpenJDK).  When
``$ICX_METEOR_JAR`` points at ``meteor-1.5.jar`` (plus its
``data/paraphrase-en.gz``) and ``java`` is on PATH, this wrapper speaks the
same line protocol (``SCORE ||| ref1 ||| ... ||| hyp`` then ``EVAL |||
stats``) — bit-parity with the reference.  Without a jar, scoring falls
back to the in-process METEOR 1.5 reimplementation
(:mod:`.meteor_native`) so evaluations always report a NUMBER, like every
reference run does; ``Meteor().backend`` says which path produced it.

``Meteor(require_jar=True)`` restores the strict jar-only behavior
(raises :class:`MeteorUnavailable` when absent) — used by the fixture
recorder, which must never record native output as jar truth.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from typing import Dict


class MeteorUnavailable(RuntimeError):
    pass


def _jar_path() -> str:
    jar = os.environ.get("ICX_METEOR_JAR", "")
    if not jar or not os.path.exists(jar):
        raise MeteorUnavailable(
            "METEOR jar not found: set $ICX_METEOR_JAR to meteor-1.5.jar")
    if shutil.which("java") is None:
        raise MeteorUnavailable("java not on PATH")
    return jar


def jar_available() -> bool:
    try:
        _jar_path()
        return True
    except MeteorUnavailable:
        return False


class Meteor:
    def __init__(self, require_jar: bool = False):
        self._proc = None
        self._lock = threading.Lock()
        self._native = None
        if require_jar:
            _jar_path()                      # raise now if absent
            self.backend = "jar"
        else:
            self.backend = "jar" if jar_available() else "native"

    def _ensure_proc(self):
        if self._proc is not None:
            return
        jar = _jar_path()
        self._proc = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en",
             "-norm"],
            cwd=os.path.dirname(os.path.abspath(jar)),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            universal_newlines=True, bufsize=1)

    def compute_score(self, gts: Dict, res: Dict):
        if self.backend == "native":
            from .meteor_native import MeteorNative
            if self._native is None:
                self._native = MeteorNative()
            return self._native.compute_score(gts, res)
        assert sorted(gts.keys()) == sorted(res.keys())
        self._ensure_proc()
        scores = []
        eval_line = "EVAL"
        with self._lock:
            for key in sorted(gts.keys()):
                assert len(res[key]) == 1
                # pycocoevalcap sanitizes ONLY the hypothesis (meteor.py
                # _stat); references go to the jar verbatim — sanitizing
                # them too changes alignment input on unclean refs
                hypo = res[key][0].replace("|||", "").replace("  ", " ")
                score_line = " ||| ".join(
                    ("SCORE", " ||| ".join(gts[key]), hypo))
                self._proc.stdin.write(score_line + "\n")
                stats = self._proc.stdout.readline().strip()
                eval_line += " ||| {}".format(stats)
            self._proc.stdin.write(eval_line + "\n")
            for _ in gts:
                scores.append(float(self._proc.stdout.readline().strip()))
            final = float(self._proc.stdout.readline().strip())
        return final, scores

    def backend_detail(self) -> str:
        """The producing configuration, e.g. ``jar`` or
        ``native[exact,stem]`` — persisted next to every METEOR score
        (``METEOR_backend``) because the native scorer's stage set is
        environment-dependent (no WordNet corpus => no synonym stage) and
        scores are only comparable within one configuration."""
        if self.backend == "jar":
            return "jar"
        from .meteor_native import MeteorNative
        if self._native is None:
            self._native = MeteorNative()
        return "native[" + ",".join(self._native.stages) + "]"

    def method(self) -> str:
        return "METEOR"

    def __del__(self):
        if self._proc is not None:
            try:
                self._proc.kill()
            except Exception:
                pass
