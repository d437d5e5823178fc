"""The port's Rego formatter: tests/test_format.py on
gatekeeper_tpu_torch.rego (format(parse(src)) must re-parse to the same
AST, modulo source positions and wildcard numbering, for every
reference library template and every repo policy — the `opa fmt`
contract, vendor/.../format/format.go), and format_module's text equal
in both packages over the shipped library."""

from dataclasses import fields, is_dataclass

import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.rego.format import format_module as jformat_module
from gatekeeper_tpu.rego.parser import parse_module as jparse_module
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.rego import ast as A
from gatekeeper_tpu_torch.rego.format import format_module
from gatekeeper_tpu_torch.rego.parser import parse_module

from .test_format import REF_SRCS  # the reference library, where mounted


def canon(node, wcmap):
    """Structural normal form: drop line numbers, rename wildcards in
    first-seen order (the parser numbers them globally)."""
    if isinstance(node, A.Var) and node.name.startswith("$wc"):
        if node.name not in wcmap:
            wcmap[node.name] = f"$wc{len(wcmap)}"
        return ("Var", wcmap[node.name])
    if is_dataclass(node):
        out = [type(node).__name__]
        for f in fields(node):
            if f.name in ("line", "source_name"):
                continue
            out.append((f.name, canon(getattr(node, f.name), wcmap)))
        return tuple(out)
    if isinstance(node, tuple):
        return tuple(canon(x, wcmap) for x in node)
    return node


def roundtrip(src: str) -> None:
    m1 = parse_module(src)
    text = format_module(m1)
    m2 = parse_module(text)
    c1, c2 = canon(m1, {}), canon(m2, {})
    assert c1 == c2, f"round-trip drift:\n{text}"
    # idempotence: formatting formatted source is a fixed point
    assert format_module(m2) == text


@pytest.mark.parametrize(
    "path", REF_SRCS, ids=[str(p.parent.name) for p in REF_SRCS])
def test_roundtrip_reference_library(path):
    roundtrip(path.read_text())


def test_roundtrip_repo_policies():
    for name in tpol.names():
        t = tpol.load(name)
        for target in t["spec"]["targets"]:
            roundtrip(target["rego"])
            for lib in target.get("libs") or []:
                roundtrip(lib)


def test_format_shapes():
    src = '''
package demo

default allow = false

allow {
  input.review.kind.kind == "Pod"
  not denied
}

denied {
  some ns
  x := data.inventory.namespace[ns][_]["Pod"][name]
  count({p | p := x.spec.containers[_].name}) > 1
  y = [u | u := x.spec.volumes[_]; u.hostPath]
  m := {k: v | v := x.metadata.labels[k]}
  z := (1 + 2) * 3
  x.spec.replicas >= -1
  arr := []
  s := set()
  obj := {"a": 1}
  f(x) with input as {"review": {}}
}

f(v) = out {
  out := v
}

items[name] {
  name := input.review.object.metadata.name
}

pairs[k] = v {
  v := input.review.object.metadata.labels[k]
}
'''
    roundtrip(src)
    assert format_module(parse_module(src)) == \
        jformat_module(jparse_module(src))



def _rego_sources(pol, name) -> list:
    """A shipped template's Rego: each target's entry module and libs."""
    return [src for t in pol.load(name)["spec"]["targets"]
            for src in [t["rego"], *(t.get("libs") or [])]]


@pytest.mark.parametrize("name", tpol.names())
def test_format_equal_in_both_packages(name):
    """format_module renders each shipped template to the same text in
    the port as in the JAX package."""
    srcs = _rego_sources(tpol, name)
    assert srcs == _rego_sources(jpol, name)
    for src in srcs:
        assert format_module(parse_module(src)) == \
            jformat_module(jparse_module(src))
