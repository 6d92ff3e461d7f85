"""Schema validation of graph, paragraph-output and genotypes JSON.

Two layers, mirroring the reference's JSON-Schema checks
(share/schema/{input,output}_schema.json + schema_check.py):

- ``validate_graph_json`` / ``validate_paragraph_output``: fast
  hand-rolled structural checks of the invariants the pipeline depends
  on (cheap enough to always run where wired).
- ``validate(obj, which)``: full JSON-Schema (draft 2020-12) validation
  against the authored documents in ``paragraph_tpu/schema/*.json``,
  enforced behind the ``--validate-schemas`` pipeline flag. Violations
  raise ``SchemaError`` carrying the JSON path to the offending value.
"""
from __future__ import annotations

import functools
import json
import os
from typing import List


class SchemaError(ValueError):
    pass


_SCHEMA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "schema")
_SCHEMA_FILES = {
    "input": "input_schema.json",
    "output": "output_schema.json",
    "genotypes": "genotypes_schema.json",
}


@functools.lru_cache(maxsize=None)
def _validator(which: str):
    import jsonschema

    with open(os.path.join(_SCHEMA_DIR, _SCHEMA_FILES[which])) as f:
        schema = json.load(f)
    cls = jsonschema.validators.validator_for(schema)
    cls.check_schema(schema)
    return cls(schema)


def validate(obj: dict, which: str) -> None:
    """JSON-Schema validation: ``which`` ∈ input | output | genotypes.

    Raises SchemaError with the JSON path ("$.nodes[3].sequence: ...")
    of the first (deepest-resolved) violation.
    """
    if which not in _SCHEMA_FILES:
        raise ValueError(f"unknown schema {which!r}; "
                         f"expected one of {sorted(_SCHEMA_FILES)}")
    best = None
    for err in _validator(which).iter_errors(obj):
        import jsonschema

        err = jsonschema.exceptions.best_match([err]) or err
        if best is None or len(err.absolute_path) > len(
                best.absolute_path):
            best = err
    if best is not None:
        path = "$" + "".join(
            f"[{p}]" if isinstance(p, int) else f".{p}"
            for p in best.absolute_path)
        raise SchemaError(f"{which} schema: {path}: {best.message}")


def _require(cond: bool, path: str, msg: str):
    if not cond:
        raise SchemaError(f"{path}: {msg}")


def validate_graph_input(desc: dict) -> None:
    """JSON-Schema validation of one event graph description, accepting
    both the flat form and the event wrapper carrying a ``graph`` key."""
    root = dict(desc)
    if "graph" in root:
        root.update(root.pop("graph"))
    validate(root, "input")


def validate_graph_json(desc: dict, path: str = "graph") -> None:
    """Validate a paragraph graph description (input schema)."""
    if "graph" in desc:
        desc = {**desc, **desc["graph"]}
    _require(isinstance(desc.get("nodes"), list), path + ".nodes",
             "must be a list")
    names = set()
    n_nodes = len(desc["nodes"])
    for i, node in enumerate(desc["nodes"]):
        p = f"{path}.nodes[{i}]"
        _require(isinstance(node, dict), p, "must be an object")
        name = node.get("name", f"node-{i + 1}")
        _require(name not in names, p, f"duplicate node name {name}")
        names.add(name)
        is_source_or_sink = (
            i in (0, n_nodes - 1)
            and str(name).upper() in ("SOURCE", "SINK"))
        _require(
            "sequence" in node or "reference" in node or is_source_or_sink,
            p, "needs sequence or reference")
        if "sequence" in node:
            _require(isinstance(node["sequence"], str), p + ".sequence",
                     "must be a string")
    edges = desc.get("edges") or []
    order = {n.get("name", f"node-{i + 1}"): i
             for i, n in enumerate(desc["nodes"])}
    for i, edge in enumerate(edges):
        p = f"{path}.edges[{i}]"
        _require("from" in edge and "to" in edge, p, "needs from/to")
        _require(edge["from"] in names, p, f"unknown node {edge['from']}")
        _require(edge["to"] in names, p, f"unknown node {edge['to']}")
        _require(order[edge["from"]] < order[edge["to"]], p,
                 "edges must be topological (from-index < to-index)")
        if "sequences" in edge:
            _require(isinstance(edge["sequences"], list), p + ".sequences",
                     "must be a list")
    for i, pth in enumerate(desc.get("paths") or []):
        p = f"{path}.paths[{i}]"
        _require(isinstance(pth.get("nodes"), list), p + ".nodes",
                 "must be a list")
        for n in pth["nodes"]:
            _require(n in names, p, f"unknown node {n}")
    if "target_regions" in desc:
        _require(isinstance(desc["target_regions"], list),
                 path + ".target_regions", "must be a list")


def validate_paragraph_output(output: dict, path: str = "output") -> None:
    """Validate the per-sample paragraph output (output schema subset)."""
    for key in ("nodes", "edges"):
        _require(key in output, path, f"missing {key}")
    for key in ("read_counts_by_node", "read_counts_by_edge",
                "read_counts_by_sequence"):
        if key in output:
            _require(isinstance(output[key], dict), f"{path}.{key}",
                     "must be an object")
            for k, v in output[key].items():
                if key != "read_counts_by_sequence":
                    _require(isinstance(v, int), f"{path}.{key}.{k}",
                             "counts must be integers")
    if "alignment_statistics" in output:
        _require(isinstance(output["alignment_statistics"], dict),
                 path + ".alignment_statistics", "must be an object")
