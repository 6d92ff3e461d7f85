"""Sample manifest parsing.

Equivalent of ``genotyping::SampleInfo`` / ``loadManifest``
(the reference's src/c++/lib/genotyping/SampleInfo.cpp): tab/comma split,
columns id/path/index_path/paragraph/idxdepth/depth/read length/sex/
depth variance/depth sd; depth_sd defaults to sqrt(5·depth).
"""
from __future__ import annotations

import gzip
import json
import math
import os
import re
from typing import List, Optional

MALE = "MALE"
FEMALE = "FEMALE"
UNKNOWN = "UNKNOWN"

_LEGAL_COLUMNS = {
    "id", "path", "index_path", "paragraph", "idxdepth", "depth",
    "read length", "sex", "depth variance", "depth sd",
}


class SampleInfo:
    def __init__(self):
        self.sample_name = ""
        self.filename = ""
        self.index_filename = ""
        self.autosome_depth = -1.0
        self.read_length = -1
        self.depth_sd = 0.0
        self.sex = UNKNOWN
        self.alignment_data: Optional[dict] = None

    def set_autosome_depth(self, depth: float):
        self.autosome_depth = depth
        if self.depth_sd == 0:
            self.depth_sd = math.sqrt(depth * 5)

    def set_sex(self, sex_string: str):
        s = sex_string.lower()
        if s.startswith("m"):
            self.sex = MALE
        elif s.startswith("f"):
            self.sex = FEMALE
        elif s.startswith("u"):
            self.sex = UNKNOWN
        else:
            raise ValueError(f"illegal sex string: {sex_string}")


def _load_json_file(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def load_manifest(filename: str) -> List[SampleInfo]:
    """loadManifest (SampleInfo.cpp:84-301)."""
    samples: List[SampleInfo] = []
    header: List[str] = []
    header_map = {}
    base_dir = os.path.dirname(os.path.abspath(filename))

    def find_file(p: str) -> str:
        if p.startswith(("s3://", "http://", "https://")):
            return p
        if os.path.isfile(p):
            return p
        candidate = os.path.join(base_dir, p)
        if os.path.isfile(candidate):
            return candidate
        raise FileNotFoundError(f"File not found: {p}")

    with open(filename) as f:
        for line in f:
            line = line.replace("\n", "").replace("#", "")
            if not line:
                continue
            if not header:
                header = [h.lower() for h in re.split(r"[\t,]", line)]
                for h in header:
                    if h not in _LEGAL_COLUMNS:
                        raise ValueError(f"Unknown column {h} in manifest")
                header_map = {h: i for i, h in enumerate(header)}
                if "id" not in header_map or "path" not in header_map:
                    raise ValueError("Manifest requires id and path")
                if not ("idxdepth" in header_map
                        or ("depth" in header_map
                            and "read length" in header_map)):
                    raise ValueError(
                        "Manifest must specify idxdepth or depth and "
                        "read length")
                continue
            tokens = re.split(r"[\t,]", line)
            tokens += [""] * (len(header) - len(tokens))
            sid = SampleInfo()
            sid.sample_name = tokens[header_map["id"]]
            sid.filename = find_file(tokens[header_map["path"]])
            if "index_path" in header_map and tokens[header_map["index_path"]]:
                sid.index_filename = find_file(
                    tokens[header_map["index_path"]])

            depth = -1.0
            read_length = -1
            if "depth" in header_map and "read length" in header_map:
                try:
                    depth = float(tokens[header_map["depth"]])
                    read_length = int(tokens[header_map["read length"]])
                except (ValueError, TypeError):
                    pass
            if (depth < 0 or read_length < 0) and "idxdepth" in header_map:
                idx_path = tokens[header_map["idxdepth"]]
                if idx_path and not os.path.isfile(idx_path):
                    cand = os.path.join(base_dir, idx_path)
                    if os.path.isfile(cand):
                        idx_path = cand
                try:
                    idx_json = _load_json_file(idx_path)
                    if read_length < 0 and "read_length" in idx_json:
                        read_length = int(idx_json["read_length"])
                    if (depth < 0 and "autosome" in idx_json
                            and "depth" in idx_json["autosome"]):
                        depth = float(idx_json["autosome"]["depth"])
                except (OSError, ValueError) as e:
                    if idx_path:
                        import logging

                        logging.warning(
                            "Cannot read idxdepth for sample %s: %s -- %s",
                            sid.sample_name, idx_path, e)
            if depth <= 0 or read_length <= 0:
                raise ValueError(
                    f"No depth / read length estimate for sample "
                    f"{sid.sample_name}")
            sid.set_autosome_depth(depth)
            sid.read_length = read_length

            if "depth sd" in header_map:
                try:
                    depth_sd = float(tokens[header_map["depth sd"]])
                except (ValueError, TypeError):
                    depth_sd = 0.0
                if depth_sd <= 0:
                    raise ValueError(
                        f"Depth sd is not positive in sample "
                        f"{sid.sample_name}")
                sid.depth_sd = depth_sd
            elif "depth variance" in header_map:
                try:
                    depth_variance = float(
                        tokens[header_map["depth variance"]])
                except (ValueError, TypeError):
                    depth_variance = 0.0
                if depth_variance <= 0:
                    raise ValueError(
                        f"Depth variance is not positive in sample "
                        f"{sid.sample_name}")
                sid.depth_sd = math.sqrt(depth_variance)

            if "sex" in header_map:
                sid.set_sex(tokens[header_map["sex"]])

            if "paragraph" in header_map:
                p_path = tokens[header_map["paragraph"]]
                if p_path and not os.path.isfile(p_path):
                    cand = os.path.join(base_dir, p_path)
                    if os.path.isfile(cand):
                        p_path = cand
                if p_path:
                    try:
                        sid.alignment_data = _load_json_file(p_path)
                    except (OSError, ValueError):
                        pass
            samples.append(sid)
    return samples
