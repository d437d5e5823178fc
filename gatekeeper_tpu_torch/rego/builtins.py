"""Builtin functions for the Rego subset.

Coverage: the builtin surface exercised by the reference policy corpus
(SURVEY.md §2.3) plus the commonly-used remainder of OPA's library —
117 builtins across strings/regex/aggregates/objects/encoding (json,
yaml, base64, hex, urlquery)/crypto (hashes, hmac)/time/units/net.cidr/
semver/bits/type checks. Semantics mirror OPA topdown
(vendor/.../opa/topdown/*.go); tests pin literal expected values.

Error semantics: a builtin raising BuiltinError makes the enclosing
expression *undefined* (the literal fails; under `not` it succeeds). This is
OPA's default non-strict builtin-error behavior that e.g.
k8scontainerlimits' `not canonify_cpu(cpu_orig)` relies on
(library/general/containerlimits/src.rego).
"""

from __future__ import annotations

import re
from typing import Any

from ..utils.values import FrozenDict, format_value, rego_eq, sort_key, type_name


class BuiltinError(Exception):
    pass


# builtins whose results must never be memoized (non-pure): the codegen
# purity analyses (arg-pure fmemo, review/params-pure rmemo/pmemo, the
# head-witness memo) all consult this set
NONDETERMINISTIC: set = {("time", "now_ns"), ("print",), ("trace",)}


_REGEX_CACHE: dict[str, "re.Pattern[str]"] = {}


def compiled_regex(pattern: str) -> "re.Pattern[str]":
    pat = _REGEX_CACHE.get(pattern)
    if pat is None:
        try:
            pat = re.compile(pattern)
        except re.error as e:
            raise BuiltinError(f"invalid regex {pattern!r}: {e}") from None
        _REGEX_CACHE[pattern] = pat
    return pat


def _need(v: Any, ty: str, fn: str) -> Any:
    if type_name(v) != ty:
        raise BuiltinError(f"{fn}: expected {ty}, got {type_name(v)}")
    return v


def _need_str(v: Any, fn: str) -> str:
    return _need(v, "string", fn)


def _need_num(v: Any, fn: str):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise BuiltinError(f"{fn}: expected number, got {type_name(v)}")
    return v


def _iterable(v: Any, fn: str):
    if isinstance(v, (tuple, frozenset)):
        return list(v)
    if isinstance(v, FrozenDict):
        return list(v.values())
    raise BuiltinError(f"{fn}: expected collection, got {type_name(v)}")


def bi_count(v):
    if isinstance(v, str):
        return len(v)
    if isinstance(v, (tuple, frozenset, FrozenDict)):
        return len(v)
    raise BuiltinError(f"count: cannot count {type_name(v)}")


def bi_to_number(v):
    if v is None:
        return 0
    if isinstance(v, bool):
        return 1 if v else 0
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            try:
                f = float(v)
            except ValueError:
                raise BuiltinError(f"to_number: invalid number {v!r}") from None
            return int(f) if f.is_integer() else f
    raise BuiltinError(f"to_number: cannot convert {type_name(v)}")


def bi_substring(s, start, length):
    s = _need_str(s, "substring")
    start = int(_need_num(start, "substring"))
    length = int(_need_num(length, "substring"))
    if start < 0:
        raise BuiltinError("substring: negative start")
    if length < 0:
        return s[start:]
    return s[start : start + length]


def bi_sprintf(fmt, args):
    fmt = _need_str(fmt, "sprintf")
    args = list(_need(args, "array", "sprintf"))
    out = []
    i, n = 0, len(fmt)
    ai = 0
    while i < n:
        c = fmt[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        if i + 1 < n and fmt[i + 1] == "%":
            out.append("%")
            i += 2
            continue
        # parse verb (with optional width/precision, which we pass through to %-style)
        j = i + 1
        while j < n and fmt[j] in "+-# 0123456789.":
            j += 1
        if j >= n:
            raise BuiltinError("sprintf: trailing %")
        verb = fmt[j]
        spec = fmt[i + 1 : j]
        if ai >= len(args):
            raise BuiltinError("sprintf: not enough arguments")
        arg = args[ai]
        ai += 1
        if verb == "v":
            out.append(format_value(arg, top=True))
        elif verb == "s":
            out.append(arg if isinstance(arg, str) else format_value(arg, top=True))
        elif verb in "dxXob":
            out.append(("%" + spec + verb) % int(_need_num(arg, "sprintf")))
        elif verb in "feEgG":
            out.append(("%" + spec + verb) % float(_need_num(arg, "sprintf")))
        else:
            raise BuiltinError(f"sprintf: unsupported verb %{verb}")
        i = j + 1
    return "".join(out)


def bi_min(coll):
    items = _iterable(coll, "min")
    if not items:
        raise BuiltinError("min: empty collection")
    return min(items, key=sort_key)


def bi_max(coll):
    items = _iterable(coll, "max")
    if not items:
        raise BuiltinError("max: empty collection")
    return max(items, key=sort_key)


def bi_trim(s, cutset):
    return _need_str(s, "trim").strip(_need_str(cutset, "trim"))


def bi_concat(delim, coll):
    delim = _need_str(delim, "concat")
    items = coll if isinstance(coll, tuple) else sorted(coll, key=sort_key) if isinstance(coll, frozenset) else None
    if items is None:
        raise BuiltinError("concat: expected array or set")
    for x in items:
        _need_str(x, "concat")
    return delim.join(items)


def bi_any(coll):
    items = _iterable(coll, "any")
    return any(x is True for x in items)


def bi_all(coll):
    items = _iterable(coll, "all")
    return all(x is True for x in items)


BUILTINS: dict[tuple, Any] = {
    ("count",): bi_count,
    ("to_number",): bi_to_number,
    ("substring",): bi_substring,
    ("sprintf",): bi_sprintf,
    ("min",): bi_min,
    ("max",): bi_max,
    ("sum",): lambda c: sum(_need_num(x, "sum") for x in _iterable(c, "sum")),
    ("product",): lambda c: __import__("math").prod(
        _need_num(x, "product") for x in _iterable(c, "product")
    ),
    ("any",): bi_any,
    ("all",): bi_all,
    ("trim",): bi_trim,
    ("trim_space",): lambda s: _need_str(s, "trim_space").strip(),
    ("concat",): bi_concat,
    ("split",): lambda s, d: tuple(
        _need_str(s, "split").split(_need_str(d, "split"))
    ),
    ("replace",): lambda s, o, nw: _need_str(s, "replace").replace(
        _need_str(o, "replace"), _need_str(nw, "replace")
    ),
    ("startswith",): lambda s, p: _need_str(s, "startswith").startswith(
        _need_str(p, "startswith")
    ),
    ("endswith",): lambda s, p: _need_str(s, "endswith").endswith(
        _need_str(p, "endswith")
    ),
    ("contains",): lambda s, p: _need_str(p, "contains") in _need_str(s, "contains"),
    ("indexof",): lambda s, p: _need_str(s, "indexof").find(_need_str(p, "indexof")),
    ("lower",): lambda s: _need_str(s, "lower").lower(),
    ("upper",): lambda s: _need_str(s, "upper").upper(),
    ("format_int",): lambda v, b: {2: "{:b}", 8: "{:o}", 10: "{:d}", 16: "{:x}"}[
        int(_need_num(b, "format_int"))
    ].format(int(_need_num(v, "format_int"))),
    ("abs",): lambda v: abs(_need_num(v, "abs")),
    ("round",): lambda v: int(round(_need_num(v, "round"))),
    ("sort",): lambda c: tuple(sorted(_iterable(c, "sort"), key=sort_key)),
    ("to_string",): lambda v: format_value(v, top=True),
    ("re_match",): lambda p, v: bool(
        compiled_regex(_need_str(p, "re_match")).search(_need_str(v, "re_match"))
    ),
    ("regex", "match"): lambda p, v: bool(
        compiled_regex(_need_str(p, "regex.match")).search(
            _need_str(v, "regex.match")
        )
    ),
    ("is_string",): lambda v: isinstance(v, str),
    ("is_number",): lambda v: not isinstance(v, bool) and isinstance(v, (int, float)),
    ("is_boolean",): lambda v: isinstance(v, bool),
    ("is_null",): lambda v: v is None,
    ("is_array",): lambda v: isinstance(v, tuple),
    ("is_object",): lambda v: isinstance(v, FrozenDict),
    ("is_set",): lambda v: isinstance(v, frozenset),
    ("array", "concat"): lambda a, b: _need(a, "array", "array.concat")
    + _need(b, "array", "array.concat"),
    ("array", "slice"): lambda a, i, j: _need(a, "array", "array.slice")[
        int(_need_num(i, "array.slice")) : int(_need_num(j, "array.slice"))
    ],
    ("object", "get"): lambda o, k, d: o.get(k, d)
    if isinstance(o, FrozenDict)
    else d,
    ("equal",): rego_eq,
    ("neq",): lambda a, b: not rego_eq(a, b),
    ("cast_array",): lambda v: tuple(v)
    if isinstance(v, (tuple, frozenset))
    else (_ for _ in ()).throw(BuiltinError("cast_array")),
    ("cast_string",): lambda v: _need_str(v, "cast_string"),
    ("cast_boolean",): lambda v: _need(v, "boolean", "cast_boolean"),
    # debugging no-ops (OPA topdown/trace.go): always true so bodies continue
    ("trace",): lambda *a: True,
    ("print",): lambda *a: True,
}


# ------------------------------------------------- breadth batch (r3)
# Builtins beyond the reference corpus' needs, for policy portability:
# the OPA v0.2x surface k8s policies most commonly reach for.


def _canon_json(v) -> str:
    """The one canonical JSON serialization (json.marshal, JWT signing
    payloads, http.send bodies) — a single definition so OPA-parity
    tweaks to number/key rendering can never diverge between them."""
    import json as _json

    from ..utils.values import thaw

    return _json.dumps(thaw(v), sort_keys=True, separators=(",", ":"))


def _bi_json_marshal(v):
    try:
        return _canon_json(v)
    except (TypeError, ValueError) as e:
        raise BuiltinError(f"json.marshal: {e}") from None


def _bi_json_unmarshal(s):
    import json as _json

    from ..utils.values import freeze

    try:
        return freeze(_json.loads(_need_str(s, "json.unmarshal")))
    except ValueError as e:
        raise BuiltinError(f"json.unmarshal: {e}") from None


def _b64(codec, name):
    import base64 as _b

    fn = getattr(_b, codec)

    def run(s):
        try:
            return fn(_need_str(s, name).encode()).decode()
        except Exception as e:  # noqa: BLE001
            raise BuiltinError(f"{name}: {e}") from None

    return run


def _b64dec(codec, name):
    import base64 as _b

    fn = getattr(_b, codec)

    def run(s):
        try:
            return fn(_need_str(s, name).encode()).decode()
        except Exception as e:  # noqa: BLE001
            raise BuiltinError(f"{name}: {e}") from None

    return run


def _bi_glob_match(pattern, delimiters, value):
    """OPA glob.match subset: *, **, ?, [classes], {alt,ernates};
    bare * and ? do not cross a delimiter (default ".")."""
    pattern = _need_str(pattern, "glob.match")
    value = _need_str(value, "glob.match")
    if delimiters is None:
        delims = ["."]
    else:
        delims = [_need_str(d, "glob.match")
                  for d in _iterable(delimiters, "glob.match")] or ["."]
    d = re.escape("".join(delims))
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            if pattern[i:i + 2] == "**":
                out.append(".*")
                i += 2
            else:
                out.append(f"[^{d}]*")
                i += 1
        elif c == "?":
            out.append(f"[^{d}]")
            i += 1
        elif c == "[":
            j = pattern.find("]", i + 1)
            if j < 0:
                raise BuiltinError("glob.match: unterminated class")
            out.append(pattern[i:j + 1])
            i = j + 1
        elif c == "{":
            j = pattern.find("}", i + 1)
            if j < 0:
                raise BuiltinError("glob.match: unterminated alternates")
            alts = pattern[i + 1:j].split(",")
            out.append("(" + "|".join(re.escape(a) for a in alts) + ")")
            i = j + 1
        else:
            out.append(re.escape(c))
            i += 1
    return re.fullmatch("".join(out), value) is not None


def _bi_numbers_range(a, b):
    lo = int(_need_num(a, "numbers.range"))
    hi = int(_need_num(b, "numbers.range"))
    step = 1 if hi >= lo else -1
    return tuple(range(lo, hi + step, step))


def _bi_union(sets):
    out: frozenset = frozenset()
    for s in _iterable(sets, "union"):
        out |= _need(s, "set", "union")
    return out


def _bi_intersection(sets):
    items = [_need(s, "set", "intersection")
             for s in _iterable(sets, "intersection")]
    if not items:
        return frozenset()
    out = items[0]
    for s in items[1:]:
        out &= s
    return out


def _trim_side(side):
    def run(s, cutset):
        v = _need_str(s, f"trim_{side}")
        cut = _need_str(cutset, f"trim_{side}")
        if not cut:
            return v
        return v.lstrip(cut) if side == "left" else v.rstrip(cut)

    return run


BUILTINS.update({
    ("json", "marshal"): _bi_json_marshal,
    ("json", "unmarshal"): _bi_json_unmarshal,
    ("base64", "encode"): _b64("b64encode", "base64.encode"),
    ("base64", "decode"): _b64dec("b64decode", "base64.decode"),
    ("base64url", "encode"): _b64("urlsafe_b64encode", "base64url.encode"),
    ("base64url", "decode"): _b64dec("urlsafe_b64decode",
                                     "base64url.decode"),
    ("glob", "match"): _bi_glob_match,
    ("numbers", "range"): _bi_numbers_range,
    ("union",): _bi_union,
    ("intersection",): _bi_intersection,
    ("type_name",): type_name,
    ("trim_left",): _trim_side("left"),
    ("trim_right",): _trim_side("right"),
    ("trim_prefix",): lambda s, p: _need_str(s, "trim_prefix")[
        len(_need_str(p, "trim_prefix")):]
    if _need_str(s, "trim_prefix").startswith(_need_str(p, "trim_prefix"))
    else _need_str(s, "trim_prefix"),
    ("trim_suffix",): lambda s, p: _need_str(s, "trim_suffix")[
        : len(_need_str(s, "trim_suffix")) - len(_need_str(p, "trim_suffix"))]
    if _need_str(p, "trim_suffix")
    and _need_str(s, "trim_suffix").endswith(_need_str(p, "trim_suffix"))
    else _need_str(s, "trim_suffix"),
})


# ---- breadth batch 2 (round 4): the commonly-used remainder of OPA's
# builtin surface (vendor/.../opa/topdown/*.go semantics; frozen values
# in and out, BuiltinError -> undefined)

import base64 as _base64
import binascii as _binascii
import json
import datetime as _dt
import hashlib as _hashlib
import hmac as _hmac_mod
import ipaddress as _ipaddress
import math as _math
import time as _time
import urllib.parse as _urlparse

from ..utils.values import freeze, thaw


def _bi_object_keys(o):
    _need(o, "object", "object.keys")
    return frozenset(o.keys())


def _bi_object_remove(o, ks):
    _need(o, "object", "object.remove")
    drop = set(_iterable(ks, "object.remove"))
    return FrozenDict((k, v) for k, v in o.items()
                      if not any(rego_eq(k, d) for d in drop))


def _bi_object_filter(o, ks):
    _need(o, "object", "object.filter")
    keep = set(_iterable(ks, "object.filter"))
    return FrozenDict((k, v) for k, v in o.items()
                      if any(rego_eq(k, d) for d in keep))


def _bi_object_union(a, b):
    _need(a, "object", "object.union")
    _need(b, "object", "object.union")

    def merge(x, y):
        if isinstance(x, FrozenDict) and isinstance(y, FrozenDict):
            out = dict(x)
            for k, v in y.items():
                out[k] = merge(out[k], v) if k in out else v
            return FrozenDict(out)
        return y

    return merge(a, b)


def _bi_object_union_n(objs):
    items = _iterable(objs, "object.union_n")
    out = FrozenDict()
    for o in items:
        out = _bi_object_union(out, _need(o, "object", "object.union_n"))
    return out


def _bi_regex_split(pattern, s):
    return tuple(compiled_regex(_need_str(pattern, "regex.split")).split(
        _need_str(s, "regex.split")))


def _bi_regex_is_valid(pattern):
    if not isinstance(pattern, str):
        return False
    try:
        re.compile(pattern)
        return True
    except re.error:
        return False


_GO_REF = re.compile(r"\$(\$|\{[A-Za-z0-9_]+\}|[A-Za-z0-9_]+)")


def _go_expand(template: str, m: "re.Match") -> str:
    """Go regexp.Expand: $1/${name} are submatch references; $$ is a
    literal $; unknown groups expand to the empty string."""
    def ref(rm):
        name = rm.group(1)
        if name == "$":
            return "$"
        if name.startswith("{"):
            name = name[1:-1]
        try:
            if name.isdigit():
                idx = int(name)
                if idx > m.re.groups:
                    return ""
                return m.group(idx) or ""
            return m.group(name) or ""
        except IndexError:  # unknown group: empty (Go Expand)
            return ""
    return _GO_REF.sub(ref, template)


def _bi_regex_replace(s, pattern, value):
    pat = compiled_regex(_need_str(pattern, "regex.replace"))
    tmpl = _need_str(value, "regex.replace")
    return pat.sub(lambda m: _go_expand(tmpl, m),
                   _need_str(s, "regex.replace"))


def _bi_regex_find_n(pattern, s, n):
    pat = compiled_regex(_need_str(pattern, "regex.find_n"))
    cnt = int(_need_num(n, "regex.find_n"))
    out = [m.group(0) for m in pat.finditer(_need_str(s, "regex.find_n"))]
    return tuple(out if cnt < 0 else out[:cnt])


def _bi_strings_reverse(s):
    return _need_str(s, "strings.reverse")[::-1]


def _bi_strings_count(s, sub):
    return _need_str(s, "strings.count").count(
        _need_str(sub, "strings.count"))


def _bi_indexof_n(s, sub):
    h = _need_str(s, "indexof_n")
    n = _need_str(sub, "indexof_n")
    out, i = [], h.find(n)
    while i != -1:
        out.append(i)
        i = h.find(n, i + 1)
    return tuple(out)


def _bi_replace_n(patterns, s):
    _need(patterns, "object", "strings.replace_n")
    out = _need_str(s, "strings.replace_n")
    for old, new in patterns.items():
        out = out.replace(_need_str(old, "strings.replace_n"),
                          _need_str(new, "strings.replace_n"))
    return out


def _bi_any_prefix_match(search, base):
    ss = [search] if isinstance(search, str) else \
        _iterable(search, "strings.any_prefix_match")
    bs = [base] if isinstance(base, str) else \
        _iterable(base, "strings.any_prefix_match")
    return any(_need_str(s, "strings.any_prefix_match").startswith(
        _need_str(b, "strings.any_prefix_match")) for s in ss for b in bs)


def _bi_any_suffix_match(search, base):
    ss = [search] if isinstance(search, str) else \
        _iterable(search, "strings.any_suffix_match")
    bs = [base] if isinstance(base, str) else \
        _iterable(base, "strings.any_suffix_match")
    return any(_need_str(s, "strings.any_suffix_match").endswith(
        _need_str(b, "strings.any_suffix_match")) for s in ss for b in bs)


def _bi_hex_encode(s):
    return _need_str(s, "hex.encode").encode().hex()


def _bi_hex_decode(s):
    try:
        return bytes.fromhex(_need_str(s, "hex.decode")).decode()
    except (ValueError, UnicodeDecodeError) as e:
        raise BuiltinError(f"hex.decode: {e}") from None


def _bi_urlquery_encode(s):
    return _urlparse.quote_plus(_need_str(s, "urlquery.encode"))


def _bi_urlquery_decode(s):
    return _urlparse.unquote_plus(_need_str(s, "urlquery.decode"))


def _bi_urlquery_encode_object(o):
    _need(o, "object", "urlquery.encode_object")
    parts = []
    for k, v in o.items():
        key = _urlparse.quote_plus(_need_str(k, "urlquery.encode_object"))
        vals = [v] if isinstance(v, str) else \
            _iterable(v, "urlquery.encode_object")
        for x in vals:
            parts.append(f"{key}="
                         f"{_urlparse.quote_plus(_need_str(x, 'urlquery'))}")
    return "&".join(parts)


def _bi_urlquery_decode_object(s):
    parsed = _urlparse.parse_qs(_need_str(s, "urlquery.decode_object"),
                                keep_blank_values=True)
    return FrozenDict((k, tuple(v)) for k, v in parsed.items())


def _bi_json_is_valid(s):
    if not isinstance(s, str):
        return False
    try:
        json.loads(s)
        return True
    except ValueError:
        return False


def _bi_yaml_marshal(v):
    import yaml as _yaml
    return _yaml.safe_dump(thaw(v), default_flow_style=False)


def _bi_yaml_unmarshal(s):
    import yaml as _yaml
    try:
        return freeze(_yaml.safe_load(_need_str(s, "yaml.unmarshal")))
    except _yaml.YAMLError as e:
        raise BuiltinError(f"yaml.unmarshal: {e}") from None


def _bi_yaml_is_valid(s):
    import yaml as _yaml
    if not isinstance(s, str):
        return False
    try:
        _yaml.safe_load(s)
        return True
    except _yaml.YAMLError:
        return False


def _bi_base64_is_valid(s):
    if not isinstance(s, str):
        return False
    try:
        _base64.b64decode(s, validate=True)
        return True
    except (_binascii.Error, ValueError):
        return False


def _hash(algo):
    def run(s):
        return getattr(_hashlib, algo)(
            _need_str(s, f"crypto.{algo}").encode()).hexdigest()
    return run


def _hmac(algo):
    def run(s, key):
        return _hmac_new(_need_str(key, f"crypto.hmac.{algo}"),
                         _need_str(s, f"crypto.hmac.{algo}"), algo)
    return run


def _hmac_new(key: str, msg: str, algo: str) -> str:
    return _hmac_mod.new(key.encode(), msg.encode(),
                         getattr(_hashlib, algo)).hexdigest()


def _bi_ceil(x):
    return int(_math.ceil(_need_num(x, "ceil")))


def _bi_floor(x):
    return int(_math.floor(_need_num(x, "floor")))


def _bi_numbers_range_step(a, b, step):
    lo = _need_num(a, "numbers.range_step")
    hi = _need_num(b, "numbers.range_step")
    st = _need_num(step, "numbers.range_step")
    if not float(st).is_integer() or st <= 0:
        raise BuiltinError("numbers.range_step: step must be a positive "
                           "integer")
    st = int(st)
    if lo <= hi:
        return tuple(range(int(lo), int(hi) + 1, st))
    return tuple(range(int(lo), int(hi) - 1, -st))


def _bi_array_reverse(a):
    _need(a, "array", "array.reverse")
    return tuple(reversed(a))


def _bi_time_now_ns():
    return int(_time.time() * 1e9)


_FRAC_RE = re.compile(r"\.(\d+)")


def _bi_parse_rfc3339_ns(s):
    v = _need_str(s, "time.parse_rfc3339_ns")
    try:
        if v.endswith("Z"):
            v = v[:-1] + "+00:00"
        frac_ns = 0
        fm = _FRAC_RE.search(v)
        if fm:
            digits = fm.group(1)[:9]
            frac_ns = int(digits.ljust(9, "0"))
            v = v[: fm.start()] + v[fm.end():]
        dt = _dt.datetime.fromisoformat(v)
    except ValueError as e:
        raise BuiltinError(f"time.parse_rfc3339_ns: {e}") from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp()) * 10**9 + frac_ns


def _ns_split(ns) -> tuple["_dt.datetime", int]:
    """(civil datetime of the whole seconds, sub-second ns) — carrying
    the remainder separately keeps builtins nanosecond-exact (OPA's
    topdown is; rounding through datetime.microsecond loses sub-us)."""
    s, rem = divmod(int(_need_num(ns, "time")), 10**9)
    return _dt.datetime.fromtimestamp(s, tz=_dt.timezone.utc), rem


def _ns_to_dt(ns) -> "_dt.datetime":
    d, rem = _ns_split(ns)
    return d.replace(microsecond=rem // 1000)


def _bi_time_date(ns):
    d = _ns_to_dt(ns)
    return (d.year, d.month, d.day)


def _bi_time_clock(ns):
    d = _ns_to_dt(ns)
    return (d.hour, d.minute, d.second)


def _bi_time_weekday(ns):
    return _ns_to_dt(ns).strftime("%A")


def _bi_time_add_date(ns, years, months, days):
    d, sub_ns = _ns_split(ns)
    y = int(_need_num(years, "time.add_date"))
    mo = int(_need_num(months, "time.add_date"))
    dd = int(_need_num(days, "time.add_date"))
    month0 = d.month - 1 + mo
    year = d.year + y + month0 // 12
    month = month0 % 12 + 1
    # Go's AddDate normalizes out-of-range days by rolling over
    day = d.day
    base = _dt.datetime(year, month, 1, d.hour, d.minute, d.second,
                        tzinfo=_dt.timezone.utc)
    out = base + _dt.timedelta(days=day - 1 + dd)
    # the sub-second ns ride through untouched (ns-exact like topdown)
    return int(out.timestamp()) * 10**9 + sub_ns


_UNITS = {"": 1, "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12,
          "p": 10**15, "e": 10**18,
          "ki": 2**10, "mi": 2**20, "gi": 2**30, "ti": 2**40,
          "pi": 2**50, "ei": 2**60}


def _parse_units(s: str, fn: str, milli_ok: bool, bytes_ok: bool):
    v = _need_str(s, fn).strip().strip('"')
    if not v:
        raise BuiltinError(f"{fn}: no amount provided")
    i = len(v)
    while i > 0 and not (v[i - 1].isdigit() or v[i - 1] == "."):
        i -= 1
    num, raw = v[:i], v[i:]
    if not num:
        raise BuiltinError(f"{fn}: no amount provided")
    try:
        base = float(num) if "." in num else int(num)
    except ValueError as e:
        raise BuiltinError(f"{fn}: {e}") from None
    if milli_ok and raw == "m":  # case-sensitive: 'M' is mega, 'm' milli
        return base / 1000
    suffix = raw.lower()
    if bytes_ok:  # only parse_bytes accepts b/KB/KiB spellings
        if suffix == "b":
            suffix = ""
        elif suffix.endswith("b") and suffix[:-1] in _UNITS:
            suffix = suffix[:-1]
    if suffix not in _UNITS:
        raise BuiltinError(f"{fn}: unknown unit suffix {raw!r}")
    out = base * _UNITS[suffix]
    return int(out) if float(out).is_integer() else out


def _bi_units_parse(s):
    # decimal k/M/G... and binary Ki/Mi/Gi... (no bytes 'b' suffix)
    return _parse_units(s, "units.parse", milli_ok=True, bytes_ok=False)


def _bi_units_parse_bytes(s):
    return int(_parse_units(s, "units.parse_bytes", milli_ok=False,
                            bytes_ok=True))


def _net(v, fn):
    try:
        s = _need_str(v, fn)
        if "/" in s:
            return _ipaddress.ip_network(s, strict=False)
        return _ipaddress.ip_network(s + "/32" if ":" not in s
                                     else s + "/128", strict=False)
    except ValueError as e:
        raise BuiltinError(f"{fn}: {e}") from None


def _bi_cidr_contains(cidr, x):
    net = _net(cidr, "net.cidr_contains")
    other = _net(x, "net.cidr_contains")
    try:
        return other.subnet_of(net)
    except TypeError as e:  # mixed IPv4/IPv6: undefined, not a crash
        raise BuiltinError(f"net.cidr_contains: {e}") from None


def _bi_cidr_intersects(a, b):
    try:
        return _net(a, "net.cidr_intersects").overlaps(
            _net(b, "net.cidr_intersects"))
    except TypeError as e:
        raise BuiltinError(f"net.cidr_intersects: {e}") from None


def _bi_cidr_is_valid(v):
    if not isinstance(v, str):
        return False
    try:
        _ipaddress.ip_network(v, strict=False)
        return True
    except ValueError:
        return False


_SEMVER = re.compile(
    r"^(\d+)\.(\d+)\.(\d+)(?:-([0-9A-Za-z.-]+))?(?:\+[0-9A-Za-z.-]+)?$")


def _semver_key(v: str, fn: str):
    m = _SEMVER.match(_need_str(v, fn))
    if not m:
        raise BuiltinError(f"{fn}: invalid semver {v!r}")
    major, minor, patch = int(m.group(1)), int(m.group(2)), int(m.group(3))
    pre = m.group(4)
    if pre is None:
        pre_key = (1,)  # releases sort after any pre-release
    else:
        parts = []
        for p in pre.split("."):
            parts.append((0, int(p)) if p.isdigit() else (1, p))
        pre_key = (0, tuple(parts))
    return (major, minor, patch, pre_key)


def _bi_semver_is_valid(v):
    return isinstance(v, str) and bool(_SEMVER.match(v))


def _bi_semver_compare(a, b):
    ka = _semver_key(a, "semver.compare")
    kb = _semver_key(b, "semver.compare")
    return -1 if ka < kb else (1 if ka > kb else 0)


def _bits(fn_name, op):
    def run(a, b):
        x = _need_num(a, fn_name)
        y = _need_num(b, fn_name)
        if not float(x).is_integer() or not float(y).is_integer():
            raise BuiltinError(f"{fn_name}: operands must be integers")
        return op(int(x), int(y))
    return run


BUILTINS.update({
    ("object", "keys"): _bi_object_keys,
    ("object", "remove"): _bi_object_remove,
    ("object", "filter"): _bi_object_filter,
    ("object", "union"): _bi_object_union,
    ("object", "union_n"): _bi_object_union_n,
    ("regex", "split"): _bi_regex_split,
    ("regex", "is_valid"): _bi_regex_is_valid,
    ("regex", "replace"): _bi_regex_replace,
    ("regex", "find_n"): _bi_regex_find_n,
    ("strings", "reverse"): _bi_strings_reverse,
    ("strings", "count"): _bi_strings_count,
    ("strings", "replace_n"): _bi_replace_n,
    ("strings", "any_prefix_match"): _bi_any_prefix_match,
    ("strings", "any_suffix_match"): _bi_any_suffix_match,
    ("indexof_n",): _bi_indexof_n,
    ("hex", "encode"): _bi_hex_encode,
    ("hex", "decode"): _bi_hex_decode,
    ("urlquery", "encode"): _bi_urlquery_encode,
    ("urlquery", "decode"): _bi_urlquery_decode,
    ("urlquery", "encode_object"): _bi_urlquery_encode_object,
    ("urlquery", "decode_object"): _bi_urlquery_decode_object,
    ("json", "is_valid"): _bi_json_is_valid,
    ("yaml", "marshal"): _bi_yaml_marshal,
    ("yaml", "unmarshal"): _bi_yaml_unmarshal,
    ("yaml", "is_valid"): _bi_yaml_is_valid,
    ("base64", "is_valid"): _bi_base64_is_valid,
    ("crypto", "md5"): _hash("md5"),
    ("crypto", "sha1"): _hash("sha1"),
    ("crypto", "sha256"): _hash("sha256"),
    ("crypto", "hmac", "md5"): _hmac("md5"),
    ("crypto", "hmac", "sha1"): _hmac("sha1"),
    ("crypto", "hmac", "sha256"): _hmac("sha256"),
    ("crypto", "hmac", "sha512"): _hmac("sha512"),
    ("crypto", "hmac", "equal"): lambda a, b: _hmac_mod.compare_digest(
        _need_str(a, "crypto.hmac.equal"), _need_str(b, "crypto.hmac.equal")),
    ("ceil",): _bi_ceil,
    ("floor",): _bi_floor,
    ("numbers", "range_step"): _bi_numbers_range_step,
    ("array", "reverse"): _bi_array_reverse,
    ("time", "now_ns"): _bi_time_now_ns,
    ("time", "parse_rfc3339_ns"): _bi_parse_rfc3339_ns,
    ("time", "date"): _bi_time_date,
    ("time", "clock"): _bi_time_clock,
    ("time", "weekday"): _bi_time_weekday,
    ("time", "add_date"): _bi_time_add_date,
    ("units", "parse"): _bi_units_parse,
    ("units", "parse_bytes"): _bi_units_parse_bytes,
    ("net", "cidr_contains"): _bi_cidr_contains,
    ("net", "cidr_intersects"): _bi_cidr_intersects,
    ("net", "cidr_is_valid"): _bi_cidr_is_valid,
    ("semver", "is_valid"): _bi_semver_is_valid,
    ("semver", "compare"): _bi_semver_compare,
    ("bits", "or"): _bits("bits.or", lambda a, b: a | b),
    ("bits", "and"): _bits("bits.and", lambda a, b: a & b),
    ("bits", "xor"): _bits("bits.xor", lambda a, b: a ^ b),
    ("bits", "lsh"): _bits("bits.lsh", lambda a, b: a << b),
    ("bits", "rsh"): _bits("bits.rsh", lambda a, b: a >> b),
    ("bits", "negate"): lambda a: ~int(_need_num(a, "bits.negate")),
})


# ---- breadth batch 3: json document surgery, graph traversal, jwt ----


def _split_json_path(p, fn: str):
    if isinstance(p, str):
        return tuple(seg for seg in p.split("/") if seg != "")
    if isinstance(p, tuple):
        return tuple(str(x) if not isinstance(x, str) else x for x in p)
    raise BuiltinError(f"{fn}: path must be a string or array")


def _paths_trie(paths, fn: str):
    trie: dict = {}
    for p in _iterable(paths, fn):
        node = trie
        for seg in _split_json_path(p, fn):
            node = node.setdefault(seg, {})
        node["\x00end"] = True
    return trie


def _step_into(v, seg: str):
    if isinstance(v, FrozenDict):
        if seg in v:
            return True, v[seg]
        return False, None
    if isinstance(v, tuple):
        try:
            i = int(seg)
        except ValueError:
            return False, None
        if 0 <= i < len(v):
            return True, v[i]
    return False, None


def _bi_json_filter(obj, paths):
    """Keep only the listed paths (OPA topdown/json.go Filter)."""
    _need(obj, "object", "json.filter")
    trie = _paths_trie(paths, "json.filter")

    def keep(v, node):
        if "\x00end" in node:
            return v
        if isinstance(v, FrozenDict):
            out = {}
            for k, child in node.items():
                if k == "\x00end":
                    continue
                present, sub = _step_into(v, k)
                if present:
                    kept = keep(sub, child)
                    if kept is not _MISSING_JSON:
                        out[k] = kept
            return FrozenDict(out)
        if isinstance(v, tuple):
            out = []
            # original index order, not trie insertion order
            for k, child in sorted(
                    ((k, c) for k, c in node.items() if k != "\x00end"),
                    key=lambda kv: int(kv[0]) if kv[0].isdigit() else 0):
                present, sub = _step_into(v, k)
                if present:
                    kept = keep(sub, child)
                    if kept is not _MISSING_JSON:
                        out.append(kept)
            return tuple(out)
        return _MISSING_JSON

    got = keep(obj, trie)
    return got if got is not _MISSING_JSON else FrozenDict()


_MISSING_JSON = object()


def _bi_json_remove(obj, paths):
    """Remove the listed paths (OPA topdown/json.go Remove)."""
    _need(obj, "object", "json.remove")
    trie = _paths_trie(paths, "json.remove")

    def strip(v, node):
        if "\x00end" in node:
            return _MISSING_JSON
        if isinstance(v, FrozenDict):
            out = {}
            for k, sub in v.items():
                child = node.get(k if isinstance(k, str) else str(k))
                if child is None:
                    out[k] = sub
                else:
                    kept = strip(sub, child)
                    if kept is not _MISSING_JSON:
                        out[k] = kept
            return FrozenDict(out)
        if isinstance(v, tuple):
            out = []
            for i, sub in enumerate(v):
                child = node.get(str(i))
                if child is None:
                    out.append(sub)
                else:
                    kept = strip(sub, child)
                    if kept is not _MISSING_JSON:
                        out.append(kept)
            return tuple(out)
        return v

    got = strip(obj, trie)
    return got if got is not _MISSING_JSON else FrozenDict()


def _bi_object_subset(sup, sub):
    """True when sub is a (recursive) subset of sup: objects by keys,
    sets by membership, arrays by subsequence (OPA object.subset)."""
    def check(a, b):
        if isinstance(b, FrozenDict) and isinstance(a, FrozenDict):
            return all(k in a and check(a[k], v) for k, v in b.items())
        if isinstance(b, frozenset) and isinstance(a, frozenset):
            return b <= a
        if isinstance(b, tuple) and isinstance(a, tuple):
            i = 0
            for x in a:
                if i < len(b) and rego_eq(x, b[i]):
                    i += 1
            return i == len(b)
        return rego_eq(a, b)

    return check(sup, sub)


def _bi_graph_reachable(graph, initial):
    """Node set reachable from `initial` over an adjacency object whose
    values are arrays/sets of neighbor keys (OPA graph.reachable)."""
    _need(graph, "object", "graph.reachable")
    frontier = list(_iterable(initial, "graph.reachable"))
    seen = set()
    while frontier:
        n = frontier.pop()
        if n in seen:
            continue
        seen.add(n)
        nbrs = graph.get(n)
        if isinstance(nbrs, (tuple, frozenset)):
            frontier.extend(nbrs)
    return frozenset(seen)


def _b64url_decode_pad(s: str, fn: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    try:
        return _base64.urlsafe_b64decode(s + pad)
    except (_binascii.Error, ValueError) as e:
        raise BuiltinError(f"{fn}: {e}") from None


def _bi_jwt_decode(token):
    """[header, payload, signature-hex] without verification (OPA
    io.jwt.decode, topdown/tokens.go)."""
    parts = _need_str(token, "io.jwt.decode").split(".")
    if len(parts) != 3:
        raise BuiltinError("io.jwt.decode: expected 3 '.'-separated parts")
    try:
        header = json.loads(_b64url_decode_pad(parts[0], "io.jwt.decode"))
        payload = json.loads(_b64url_decode_pad(parts[1], "io.jwt.decode"))
    except ValueError as e:
        raise BuiltinError(f"io.jwt.decode: {e}") from None
    sig = _b64url_decode_pad(parts[2], "io.jwt.decode").hex()
    return (freeze(header), freeze(payload), sig)


_HS_DIGESTS = {"HS256": _hashlib.sha256, "HS384": _hashlib.sha384,
               "HS512": _hashlib.sha512}


def _jwt_verify_hs(token, secret, algo: str) -> bool:
    fn = f"io.jwt.verify_{algo.lower()}"
    parts = _need_str(token, fn).split(".")
    if len(parts) != 3:
        return False
    mac = _hmac_mod.new(_need_str(secret, fn).encode(),
                        f"{parts[0]}.{parts[1]}".encode(),
                        _HS_DIGESTS[algo]).digest()
    return _hmac_mod.compare_digest(
        mac, _b64url_decode_pad(parts[2], fn))


def _bi_jwt_verify_hs256(token, secret):
    return _jwt_verify_hs(token, secret, "HS256")


BUILTINS.update({
    ("json", "filter"): _bi_json_filter,
    ("json", "remove"): _bi_json_remove,
    ("object", "subset"): _bi_object_subset,
    ("graph", "reachable"): _bi_graph_reachable,
    ("io", "jwt", "decode"): _bi_jwt_decode,
    ("io", "jwt", "verify_hs256"): _bi_jwt_verify_hs256,
    ("base64url", "encode_no_pad"): lambda s: _base64.urlsafe_b64encode(
        _need_str(s, "base64url.encode_no_pad").encode()
    ).decode().rstrip("="),
})


def _json_ptr(path: str, fn: str) -> list:
    if path == "":
        return []
    if not path.startswith("/"):
        raise BuiltinError(f"{fn}: path must start with '/'")
    return [seg.replace("~1", "/").replace("~0", "~")
            for seg in path.split("/")[1:]]


def _patch_apply(doc, segs: list, op: str, value, fn: str):
    """Immutable RFC 6902 add/remove/replace on frozen values."""
    if not segs:
        if op == "remove":
            raise BuiltinError(f"{fn}: cannot remove the root")
        return value
    seg = segs[0]
    if isinstance(doc, FrozenDict):
        if len(segs) == 1:
            d = dict(doc)
            if op == "remove":
                if seg not in d:
                    raise BuiltinError(f"{fn}: path not found: {seg}")
                d.pop(seg)
            elif op == "replace":
                if seg not in d:
                    raise BuiltinError(f"{fn}: path not found: {seg}")
                d[seg] = value
            else:  # add
                d[seg] = value
            return FrozenDict(d)
        if seg not in doc:
            raise BuiltinError(f"{fn}: path not found: {seg}")
        d = dict(doc)
        d[seg] = _patch_apply(doc[seg], segs[1:], op, value, fn)
        return FrozenDict(d)
    if isinstance(doc, tuple):
        if seg == "-" and op == "add" and len(segs) == 1:
            return doc + (value,)
        try:
            i = int(seg)
        except ValueError:
            raise BuiltinError(f"{fn}: bad array index {seg!r}") from None
        if not (0 <= i <= len(doc) - (0 if op == "add" else 1)):
            raise BuiltinError(f"{fn}: index {i} out of range")
        if len(segs) == 1:
            if op == "add":
                return doc[:i] + (value,) + doc[i:]
            if op == "remove":
                return doc[:i] + doc[i + 1:]
            return doc[:i] + (value,) + doc[i + 1:]
        return doc[:i] + (_patch_apply(doc[i], segs[1:], op, value, fn),) \
            + doc[i + 1:]
    raise BuiltinError(f"{fn}: cannot descend into {type_name(doc)}")


def _bi_json_patch(doc, patches):
    """RFC 6902 add/remove/replace/copy/move/test (OPA json.patch)."""
    fn = "json.patch"
    out = doc
    for p in _iterable(patches, fn):
        _need(p, "object", fn)
        op = p.get("op")
        path = _json_ptr(_need_str(p.get("path", ""), fn), fn)
        if op in ("add", "replace"):
            out = _patch_apply(out, path, op, p.get("value"), fn)
        elif op == "remove":
            out = _patch_apply(out, path, "remove", None, fn)
        elif op in ("copy", "move"):
            src = _json_ptr(_need_str(p.get("from", ""), fn), fn)
            node = out
            for seg in src:
                present, node = _step_into(node, seg)
                if not present:
                    raise BuiltinError(f"{fn}: from path not found")
            if op == "move":
                out = _patch_apply(out, src, "remove", None, fn)
            out = _patch_apply(out, path, "add", node, fn)
        elif op == "test":
            node = out
            for seg in path:
                present, node = _step_into(node, seg)
                if not present:
                    raise BuiltinError(f"{fn}: test path not found")
            if not rego_eq(node, p.get("value")):
                raise BuiltinError(f"{fn}: test failed")
        else:
            raise BuiltinError(f"{fn}: unsupported op {op!r}")
    return out


def _bi_time_diff(a, b):
    """[years, months, days, hours, minutes, seconds] between two ns
    timestamps (OPA time.diff, Go-style civil difference)."""
    d1 = _ns_to_dt(a)
    d2 = _ns_to_dt(b)
    if d1 < d2:
        d1, d2 = d2, d1
    y = d1.year - d2.year
    mo = d1.month - d2.month
    dd = d1.day - d2.day
    hh = d1.hour - d2.hour
    mi = d1.minute - d2.minute
    ss = d1.second - d2.second
    if ss < 0:
        ss += 60
        mi -= 1
    if mi < 0:
        mi += 60
        hh -= 1
    if hh < 0:
        hh += 24
        dd -= 1
    if dd < 0:
        prev_month_year = d1.year if d1.month > 1 else d1.year - 1
        prev_month = d1.month - 1 if d1.month > 1 else 12
        import calendar as _cal
        dd += _cal.monthrange(prev_month_year, prev_month)[1]
        mo -= 1
    if mo < 0:
        mo += 12
        y -= 1
    return (y, mo, dd, hh, mi, ss)


BUILTINS.update({
    ("json", "patch"): _bi_json_patch,
    ("time", "diff"): _bi_time_diff,
})


# --------------------------------------------------------------- round 5
# The builtin tail to OPA parity (reference vendor/.../topdown/
# {crypto,tokens,time,cidr,regex,http}.go): x509/jwt asymmetric
# verification, Go-layout time parsing/formatting, the cidr tail, regex
# template/glob matching, gated http.send, and the named forms of the
# infix operators (callable in OPA: plus(1, 2, x)).


# offset-token render kinds: how Go prints the zone for each layout token
_TZ_TOKENS = [("Z07:00", "zcolon"), ("Z0700", "znum"),
              ("-07:00", "colon"), ("-0700", "num"), ("-07", "hour")]

# format-mode placeholders: strftime passes unknown bytes through, so
# fraction/offset render manually afterwards (ns-exact, Go-style)
_FRAC_MARK = "\x01"
_TZ_MARK = "\x02"


def _go_layout_convert(layout: str, fn: str, formatting: bool):
    """Go reference-time layout -> strftime/strptime format.

    Parse mode: offset tokens map to %z, fraction runs are dropped
    (the caller extracts fractional digits from the value for ns
    exactness). Format mode: fraction and offset become placeholder
    marks rendered manually by _bi_time_format. Returns
    (fmt, fraction (char, width) or None, tz_kind or None)."""
    tokens = [
        ("2006", "%Y"), ("January", "%B"), ("Monday", "%A"),
        ("Jan", "%b"), ("Mon", "%a"), ("15", "%H"), ("01", "%m"),
        ("02", "%d"), ("03", "%I"), ("04", "%M"), ("05", "%S"),
        ("06", "%y"), ("PM", "%p"), ("pm", "%p"), ("MST", "%Z"),
    ]
    out = []
    i = 0
    fraction = None
    tz_kind = None
    n = len(layout)
    while i < n:
        if layout[i] == "." and i + 1 < n and layout[i + 1] in "09":
            c = layout[i + 1]
            j = i + 1
            while j < n and layout[j] == c:
                j += 1
            # Go's nextStdChunk: a fractional second only when the digit
            # run ends the digit string — ".0" in "2006.01.02" is a
            # literal dot before the std01 month token, not a fraction
            if j >= n or layout[j] not in "0123456789":
                fraction = (c, j - i - 1)
                if formatting:
                    out.append(_FRAC_MARK)
                i = j
                continue
        matched = False
        for tok, kind in _TZ_TOKENS:
            if layout.startswith(tok, i):
                tz_kind = kind
                out.append(_TZ_MARK if formatting else "%z")
                i += len(tok)
                matched = True
                break
        if matched:
            continue
        for tok, fmt in tokens:
            if layout.startswith(tok, i):
                out.append(fmt)
                i += len(tok)
                break
        else:
            ch = layout[i]
            out.append("%%" if ch == "%" else ch)
            i += 1
    return "".join(out), fraction, tz_kind


def _bi_time_parse_ns(layout, value):
    """Go time.Parse semantics for the common layout tokens
    (topdown/time.go builtinParseNanos); ns-exact."""
    lay = _need_str(layout, "time.parse_ns")
    v = _need_str(value, "time.parse_ns")
    fmt, fraction, _tz = _go_layout_convert(lay, "time.parse_ns",
                                            formatting=False)
    frac_ns = 0
    if fraction is not None:
        fm = _FRAC_RE.search(v)
        if fm:
            digits = fm.group(1)[:9]
            frac_ns = int(digits.ljust(9, "0"))
            v = v[: fm.start()] + v[fm.end():]
    try:
        d = _dt.datetime.strptime(v, fmt)
    except ValueError as e:
        raise BuiltinError(f"time.parse_ns: {e}") from None
    if d.tzinfo is None:
        d = d.replace(tzinfo=_dt.timezone.utc)
    return int(d.timestamp()) * 10**9 + frac_ns


_DUR_RE = re.compile(r"([0-9]*\.?[0-9]+)(ns|us|µs|μs|ms|s|m|h)")
_DUR_NS = {"ns": 1, "us": 10**3, "µs": 10**3, "μs": 10**3,
           "ms": 10**6, "s": 10**9, "m": 60 * 10**9, "h": 3600 * 10**9}


def _bi_time_parse_duration_ns(s):
    """Go time.ParseDuration ("1h30m", "-2.5s", ...) -> ns."""
    v = _need_str(s, "time.parse_duration_ns").strip()
    sign = 1
    if v.startswith(("-", "+")):
        sign = -1 if v[0] == "-" else 1
        v = v[1:]
    if v == "0":
        return 0
    total = 0
    pos = 0
    for m in _DUR_RE.finditer(v):
        if m.start() != pos:
            raise BuiltinError(
                f"time.parse_duration_ns: invalid duration {s!r}")
        total += int(float(m.group(1)) * _DUR_NS[m.group(2)])
        pos = m.end()
    if pos != len(v) or pos == 0:
        raise BuiltinError(f"time.parse_duration_ns: invalid duration {s!r}")
    return sign * total


def _bi_time_format(x):
    """ns | [ns, tz] | [ns, tz, go-layout] -> formatted string
    (modern-OPA time.format; the vendored version predates it)."""
    lay = "2006-01-02T15:04:05Z07:00"  # RFC3339
    tz = "UTC"
    if isinstance(x, tuple):
        if not x:
            raise BuiltinError("time.format: empty array")
        ns = x[0]
        if len(x) > 1:
            tz = _need_str(x[1], "time.format") or "UTC"
        if len(x) > 2:
            lay = _need_str(x[2], "time.format")
    else:
        ns = x
    d, sub = _ns_split(ns)
    if tz not in ("UTC", ""):
        if tz == "Local":
            d = d.astimezone()
        else:
            try:
                import zoneinfo
                d = d.astimezone(zoneinfo.ZoneInfo(tz))
            except Exception as e:
                raise BuiltinError(f"time.format: {e}") from None
    fmt, fraction, tz_kind = _go_layout_convert(lay, "time.format",
                                                formatting=True)
    out = d.strftime(fmt)
    if fraction is not None:
        c, width = fraction
        if c == "0":  # fixed width, trailing zeros kept
            frac = "." + f"{sub:09d}"[:width].ljust(width, "0")
        else:  # '9': trailing zeros (and a bare '.') dropped
            frac = ("." + f"{sub:09d}"[:width]).rstrip("0").rstrip(".")
        out = out.replace(_FRAC_MARK, frac)
    if tz_kind is not None:
        off = d.utcoffset() or _dt.timedelta(0)
        total = int(off.total_seconds())
        sign = "-" if total < 0 else "+"
        hh, mm = divmod(abs(total) // 60, 60)
        if tz_kind in ("zcolon", "znum") and total == 0:
            zs = "Z"
        elif tz_kind in ("zcolon", "colon"):
            zs = f"{sign}{hh:02d}:{mm:02d}"
        elif tz_kind == "hour":
            zs = f"{sign}{hh:02d}"
        else:
            zs = f"{sign}{hh:02d}{mm:02d}"
        out = out.replace(_TZ_MARK, zs)
    return out


def _bi_cidr_expand(cidr):
    try:
        net = _ipaddress.ip_network(_need_str(cidr, "net.cidr_expand"),
                                    strict=False)
    except ValueError as e:
        raise BuiltinError(f"net.cidr_expand: {e}") from None
    if net.num_addresses > (1 << 20):
        raise BuiltinError(
            f"net.cidr_expand: {cidr} expands to {net.num_addresses} "
            "addresses (limit 2^20)")
    return frozenset(str(ip) for ip in net)


def _bi_cidr_merge(addrs):
    nets4, nets6 = [], []
    for a in _iterable(addrs, "net.cidr_merge"):
        n = _net(a, "net.cidr_merge")
        (nets4 if n.version == 4 else nets6).append(n)
    out = []
    for group in (nets4, nets6):
        out.extend(_ipaddress.collapse_addresses(group))
    return frozenset(str(n) for n in out)


def _cidr_contains_pair(cidr, x, fn):
    a = _net(cidr, fn)
    b = _net(x, fn)
    if a.version != b.version:
        return False
    return b.network_address >= a.network_address and \
        b.broadcast_address <= a.broadcast_address


def _cidr_match_iter(operand, v, fn):
    """(cidr, index) pairs per topdown/cidr.go
    evalNetCIDRContainsMatchesOperand: string -> itself; array -> first
    element of each entry, integer index; set -> member as index;
    object -> value's cidr, key as index."""
    def term(x):
        if isinstance(x, str):
            return x
        if isinstance(x, tuple) and x:
            return x[0]
        raise BuiltinError(
            f"{fn}: operand {operand}: element must be string or "
            "non-empty array")

    if isinstance(v, str):
        yield v, v
    elif isinstance(v, tuple):
        for i, x in enumerate(v):
            yield term(x), i
    elif isinstance(v, frozenset):
        for x in sorted(v, key=sort_key):
            yield term(x), x
    elif isinstance(v, FrozenDict):
        for k, x in v.items():
            yield term(x), k
    else:
        raise BuiltinError(f"{fn}: operand {operand} must be "
                           "string/array/set/object")


def _bi_cidr_contains_matches(cidrs, xs):
    fn = "net.cidr_contains_matches"
    out = set()
    for cidr, i1 in _cidr_match_iter(1, cidrs, fn):
        for x, i2 in _cidr_match_iter(2, xs, fn):
            if _cidr_contains_pair(cidr, x, fn):
                out.add((i1, i2))
    return frozenset(out)


def _bi_regex_template_match(template, value, start, end):
    """Gorilla-mux template matching (topdown/regex_template.go):
    text outside single-char delimiters is literal, inside is regex;
    the assembled pattern is anchored both ends."""
    fn = "regex.template_match"
    tpl = _need_str(template, fn)
    v = _need_str(value, fn)
    ds = _need_str(start, fn)
    de = _need_str(end, fn)
    if len(ds) != 1 or len(de) != 1:
        raise BuiltinError(f"{fn}: delimiters must be exactly one "
                           "character")
    level, idx = 0, 0
    idxs = []
    for i, ch in enumerate(tpl):
        if ch == ds:
            level += 1
            if level == 1:
                idx = i
        elif ch == de:
            level -= 1
            if level == 0:
                idxs.append((idx, i + 1))
            elif level < 0:
                raise BuiltinError(f"{fn}: unbalanced braces in {tpl!r}")
    if level != 0:
        raise BuiltinError(f"{fn}: unbalanced braces in {tpl!r}")
    pattern = ["^"]
    endpos = 0
    for (a, b) in idxs:
        pattern.append(re.escape(tpl[endpos:a]))
        pattern.append("(" + tpl[a + 1: b - 1] + ")")
        endpos = b
    pattern.append(re.escape(tpl[endpos:]))
    pattern.append("$")
    try:
        return bool(compiled_regex("".join(pattern)).search(v))
    except re.error as e:
        raise BuiltinError(f"{fn}: {e}") from None


def _bi_regex_find_all_string_submatch_n(pattern, s, n):
    fn = "regex.find_all_string_submatch_n"
    pat = _need_str(pattern, fn)
    v = _need_str(s, fn)
    limit = int(_need_num(n, fn))
    try:
        rx = compiled_regex(pat)
    except re.error as e:
        raise BuiltinError(f"{fn}: {e}") from None
    out = []
    for m in rx.finditer(v):
        if 0 <= limit <= len(out):
            break
        out.append((m.group(0),)
                   + tuple(g if g is not None else "" for g in m.groups()))
    return tuple(out)


# ---- glob-intersection (regex.globs_match, yashtewari/gintersect port)

def _glob_tokens(s: str, fn: str) -> list:
    """Parse the glob-regex subset (literals, '.', char classes, and
    * / + / ? quantifiers) into (ranges, quantifier) tokens, where
    ranges is a sorted tuple of (lo, hi) codepoint spans."""
    toks = []
    i, n = 0, len(s)
    FULL = ((0, 0x10FFFF),)
    while i < n:
        ch = s[i]
        if ch == ".":
            ranges = FULL
            i += 1
        elif ch == "[":
            j = i + 1
            neg = j < n and s[j] == "^"
            if neg:
                j += 1
            spans = []
            while j < n and s[j] != "]":
                if j + 2 < n and s[j + 1] == "-" and s[j + 2] != "]":
                    spans.append((ord(s[j]), ord(s[j + 2])))
                    j += 3
                else:
                    if s[j] == "\\" and j + 1 < n:
                        j += 1
                    spans.append((ord(s[j]), ord(s[j])))
                    j += 1
            if j >= n:
                raise BuiltinError(f"{fn}: unterminated class in {s!r}")
            spans.sort()
            if neg:
                inv, lo = [], 0
                for a, b in spans:
                    if a > lo:
                        inv.append((lo, a - 1))
                    lo = max(lo, b + 1)
                if lo <= 0x10FFFF:
                    inv.append((lo, 0x10FFFF))
                spans = inv
            ranges = tuple(spans)
            i = j + 1
        elif ch == "\\" and i + 1 < n:
            ranges = ((ord(s[i + 1]), ord(s[i + 1])),)
            i += 2
        elif ch in "*+?":
            raise BuiltinError(f"{fn}: dangling quantifier in {s!r}")
        else:
            ranges = ((ord(ch), ord(ch)),)
            i += 1
        quant = ""
        if i < n and s[i] in "*+?":
            quant = s[i]
            i += 1
        toks.append((ranges, quant))
    return toks


def _glob_nfa(toks):
    """Thompson construction: returns (transitions, accept_state) where
    transitions[state] = [(ranges, next_state)], plus epsilon moves
    encoded via state skipping: state i sits before token i."""
    # state i = position before token i; accept = len(toks)
    eps = {i: set() for i in range(len(toks) + 1)}
    for i, (_r, q) in enumerate(toks):
        if q in ("*", "?"):
            eps[i].add(i + 1)  # skip
    trans = {}
    for i, (r, q) in enumerate(toks):
        # consuming r moves past the token; * and + allow staying
        dests = {i + 1}
        if q in ("*", "+"):
            dests.add(i)
        trans[i] = [(r, d) for d in sorted(dests)]
    return eps, trans, len(toks)


def _eps_close(states, eps):
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in eps.get(s, ()):
            if t not in out:
                out.add(t)
                stack.append(t)
    return out


def _ranges_intersect(a, b) -> bool:
    for lo1, hi1 in a:
        for lo2, hi2 in b:
            if lo1 <= hi2 and lo2 <= hi1:
                return True
    return False


def _bi_regex_globs_match(a, b):
    """True iff the two glob-style regexes can match a COMMON string
    (OPA regex.globs_match via yashtewari/glob-intersection): product
    NFA reachability over intersectable character ranges."""
    fn = "regex.globs_match"
    ta = _glob_tokens(_need_str(a, fn), fn)
    tb = _glob_tokens(_need_str(b, fn), fn)
    eps_a, trans_a, acc_a = _glob_nfa(ta)
    eps_b, trans_b, acc_b = _glob_nfa(tb)
    start = (frozenset(_eps_close({0}, eps_a)),
             frozenset(_eps_close({0}, eps_b)))
    seen = {start}
    stack = [start]
    while stack:
        sa, sb = stack.pop()
        if acc_a in sa and acc_b in sb:
            return True
        # all (range_a, range_b) co-steps with non-empty intersection
        moves_a = [(r, d) for s in sa for (r, d) in trans_a.get(s, ())]
        moves_b = [(r, d) for s in sb for (r, d) in trans_b.get(s, ())]
        for ra, da in moves_a:
            na = frozenset(_eps_close({da}, eps_a))
            for rb, db in moves_b:
                if not _ranges_intersect(ra, rb):
                    continue
                nxt = (na, frozenset(_eps_close({db}, eps_b)))
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
    return False


def _bi_glob_quote_meta(s):
    """Escape glob metacharacters (Go gobwas/glob QuoteMeta)."""
    out = []
    for ch in _need_str(s, "glob.quote_meta"):
        if ch in r"*?\[]{},!":
            out.append("\\")
        out.append(ch)
    return "".join(out)


# ------------------------------------------------- x509 / JWT (crypto)

def _load_certs(s: str, fn: str) -> list:
    """PEM chain or base64-DER (OPA crypto.x509.parse_certificates
    accepts both; topdown/crypto.go)."""
    from cryptography import x509 as _x509

    certs = []
    if "-----BEGIN" in s:
        blocks = re.findall(
            r"-----BEGIN CERTIFICATE-----.*?-----END CERTIFICATE-----",
            s, re.S)
        if not blocks:
            raise BuiltinError(f"{fn}: no PEM certificates found")
        for b in blocks:
            try:
                certs.append(_x509.load_pem_x509_certificate(b.encode()))
            except ValueError as e:
                raise BuiltinError(f"{fn}: {e}") from None
    else:
        try:
            der = _base64.b64decode(s)
        except (_binascii.Error, ValueError) as e:
            raise BuiltinError(f"{fn}: {e}") from None
        from cryptography.hazmat.primitives.serialization import Encoding

        # base64 input may hold one DER cert or a concatenated chain
        while der:
            try:
                cert = _x509.load_der_x509_certificate(der)
            except ValueError as e:
                raise BuiltinError(f"{fn}: {e}") from None
            certs.append(cert)
            der = der[len(cert.public_bytes(Encoding.DER)):]
    return certs


def _name_dict(name) -> "FrozenDict":
    from cryptography.x509.oid import NameOID

    fields = {
        NameOID.COMMON_NAME: "CommonName",
        NameOID.ORGANIZATION_NAME: "Organization",
        NameOID.ORGANIZATIONAL_UNIT_NAME: "OrganizationalUnit",
        NameOID.COUNTRY_NAME: "Country",
        NameOID.LOCALITY_NAME: "Locality",
        NameOID.STATE_OR_PROVINCE_NAME: "Province",
    }
    out: dict = {}
    for attr in name:
        key = fields.get(attr.oid)
        if key == "CommonName":
            out[key] = attr.value
        elif key is not None:
            out.setdefault(key, []).append(attr.value)
    return freeze(out)


def _bi_x509_parse_certificates(s):
    """Array of certificate objects with the Go x509.Certificate JSON
    field names the library surface uses (Subject/Issuer/NotBefore/
    NotAfter/DNSNames/IsCA/SerialNumber/Version); not the full Go
    struct marshal."""
    fn = "crypto.x509.parse_certificates"
    from cryptography import x509 as _x509

    out = []
    for cert in _load_certs(_need_str(s, fn), fn):
        dns_names: list = []
        is_ca = False
        try:
            san = cert.extensions.get_extension_for_class(
                _x509.SubjectAlternativeName)
            dns_names = san.value.get_values_for_type(_x509.DNSName)
        except _x509.ExtensionNotFound:
            pass
        try:
            bc = cert.extensions.get_extension_for_class(
                _x509.BasicConstraints)
            is_ca = bool(bc.value.ca)
        except _x509.ExtensionNotFound:
            pass
        out.append(freeze({
            "Version": cert.version.value + 1,
            "SerialNumber": str(cert.serial_number),
            "Subject": thaw(_name_dict(cert.subject)),
            "Issuer": thaw(_name_dict(cert.issuer)),
            "NotBefore": cert.not_valid_before_utc.strftime(
                "%Y-%m-%dT%H:%M:%SZ"),
            "NotAfter": cert.not_valid_after_utc.strftime(
                "%Y-%m-%dT%H:%M:%SZ"),
            "DNSNames": dns_names,
            "IsCA": is_ca,
        }))
    return tuple(out)


def _jwt_pubkey(cert_or_key: str, fn: str):
    """PEM certificate or PEM public key -> public key object."""
    from cryptography import x509 as _x509
    from cryptography.hazmat.primitives import serialization

    data = cert_or_key.encode()
    if "CERTIFICATE" in cert_or_key:
        try:
            return _x509.load_pem_x509_certificate(data).public_key()
        except ValueError as e:
            raise BuiltinError(f"{fn}: {e}") from None
    try:
        return serialization.load_pem_public_key(data)
    except ValueError as e:
        raise BuiltinError(f"{fn}: {e}") from None


# JOSE raw ECDSA signature widths: 2 coordinates of the curve byte size
# (P-256 -> 32, P-384 -> 48, P-521 -> 66)
_ES_SIG_LEN = {"ES256": 64, "ES384": 96, "ES512": 132}


def _jwt_verify_asym(token, cert, algo: str) -> bool:
    fn = f"io.jwt.verify_{algo.lower()}"
    parts = _need_str(token, fn).split(".")
    if len(parts) != 3:
        return False
    key = _jwt_pubkey(_need_str(cert, fn), fn)
    signed = f"{parts[0]}.{parts[1]}".encode()
    sig = _b64url_decode_pad(parts[2], fn)
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import (
        ec, padding, utils as asym_utils)

    family, bits = algo[:2], algo[2:]
    if family not in ("RS", "PS", "ES") or bits not in ("256", "384", "512"):
        raise BuiltinError(f"{fn}: unsupported algorithm")
    digest = {"256": hashes.SHA256, "384": hashes.SHA384,
              "512": hashes.SHA512}[bits]()
    try:
        if family == "RS":
            key.verify(sig, signed, padding.PKCS1v15(), digest)
        elif family == "PS":
            key.verify(sig, signed,
                       padding.PSS(mgf=padding.MGF1(digest),
                                   salt_length=digest.digest_size),
                       digest)
        else:
            # JOSE: raw r||s (two fixed-width big-endian ints) -> DER
            if len(sig) != _ES_SIG_LEN[algo]:
                return False
            half = len(sig) // 2
            r = int.from_bytes(sig[:half], "big")
            s_ = int.from_bytes(sig[half:], "big")
            der = asym_utils.encode_dss_signature(r, s_)
            key.verify(der, signed, ec.ECDSA(digest))
        return True
    except InvalidSignature:
        return False
    except BuiltinError:
        raise
    except Exception:
        return False


def _bi_jwt_decode_verify(token, constraints):
    """[valid, header, payload] with signature + claim checks
    (topdown/tokens.go builtinJWTDecodeVerify: cert or secret, alg pin,
    iss/aud, exp/nbf against `time` or now)."""
    fn = "io.jwt.decode_verify"
    _need(constraints, "object", fn)
    # exactly one key constraint (topdown/tokens.go parseTokenConstraints:
    # zero keys cannot verify anything, both is ambiguous) — an ERROR,
    # not a false verdict, so policies fail loudly on misconfiguration
    n_keys = ("cert" in constraints) + ("secret" in constraints)
    if n_keys == 0:
        raise BuiltinError(f"{fn}: no key constraint: one of "
                           "'cert' or 'secret' is required")
    if n_keys > 1:
        raise BuiltinError(f"{fn}: duplicate key constraints: 'cert' and "
                           "'secret' are mutually exclusive")
    try:
        header, payload, _sig = _bi_jwt_decode(token)
    except BuiltinError:
        return (False, FrozenDict(), FrozenDict())
    alg = header.get("alg")
    want_alg = constraints.get("alg")
    if want_alg is not None and alg != want_alg:
        return (False, FrozenDict(), FrozenDict())
    ok = False
    if alg in _HS_DIGESTS and "secret" in constraints:
        ok = _jwt_verify_hs(token, constraints["secret"], alg)
    elif alg in ("RS256", "PS256", "ES256", "RS384", "PS384", "ES384",
                 "RS512", "PS512", "ES512") and "cert" in constraints:
        ok = _jwt_verify_asym(token, constraints["cert"], alg)
    if not ok:
        return (False, FrozenDict(), FrozenDict())
    now_ns = constraints.get("time", int(_time.time() * 1e9))
    now_s = _need_num(now_ns, fn) / 1e9
    exp = payload.get("exp")
    if exp is not None and now_s >= _need_num(exp, fn):
        return (False, FrozenDict(), FrozenDict())
    nbf = payload.get("nbf")
    if nbf is not None and now_s < _need_num(nbf, fn):
        return (False, FrozenDict(), FrozenDict())
    iss = constraints.get("iss")
    if iss is not None and payload.get("iss") != iss:
        return (False, FrozenDict(), FrozenDict())
    aud = constraints.get("aud")
    if aud is not None:
        have = payload.get("aud")
        have_set = set(have) if isinstance(have, tuple) else {have}
        if aud not in have_set:
            return (False, FrozenDict(), FrozenDict())
    elif payload.get("aud") is not None:
        # token carries an audience the caller did not constrain: reject
        # (topdown/tokens.go validAudience)
        return (False, FrozenDict(), FrozenDict())
    return (True, header, payload)


def _b64url_nopad(b: bytes) -> str:
    return _base64.urlsafe_b64encode(b).decode().rstrip("=")


def _jwk_sign(alg: str, key, signed: bytes, fn: str) -> bytes:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import (
        ec, padding, rsa, utils as asym_utils)

    _need(key, "object", fn)
    kty = key.get("kty")
    if alg in ("HS256", "HS384", "HS512"):
        if kty != "oct":
            raise BuiltinError(f"{fn}: {alg} needs an oct key")
        secret = _b64url_decode_pad(_need_str(key.get("k"), fn), fn)
        digest = {"HS256": _hashlib.sha256, "HS384": _hashlib.sha384,
                  "HS512": _hashlib.sha512}[alg]
        return _hmac_mod.new(secret, signed, digest).digest()

    def _i(name):
        v = key.get(name)
        if v is None:
            raise BuiltinError(f"{fn}: JWK missing {name!r}")
        return int.from_bytes(_b64url_decode_pad(_need_str(v, fn), fn),
                              "big")

    if alg == "RS256":
        if kty != "RSA":
            raise BuiltinError(f"{fn}: RS256 needs an RSA key")
        pub = rsa.RSAPublicNumbers(_i("e"), _i("n"))
        priv = rsa.RSAPrivateNumbers(
            p=_i("p"), q=_i("q"), d=_i("d"), dmp1=_i("dp"), dmq1=_i("dq"),
            iqmp=_i("qi"), public_numbers=pub).private_key()
        return priv.sign(signed, padding.PKCS1v15(), hashes.SHA256())
    if alg == "ES256":
        if kty != "EC":
            raise BuiltinError(f"{fn}: ES256 needs an EC key")
        priv = ec.derive_private_key(_i("d"), ec.SECP256R1())
        der = priv.sign(signed, ec.ECDSA(hashes.SHA256()))
        r, s_ = asym_utils.decode_dss_signature(der)
        return r.to_bytes(32, "big") + s_.to_bytes(32, "big")
    raise BuiltinError(f"{fn}: unsupported algorithm {alg!r}")


def _bi_jwt_encode_sign(headers, payload, key):
    """Signed JWS from object headers/payload + JWK (topdown/tokens.go
    builtinJWTEncodeSign; HS*/RS256/ES256)."""
    fn = "io.jwt.encode_sign"
    _need(headers, "object", fn)
    _need(payload, "object", fn)
    alg = headers.get("alg")
    if not isinstance(alg, str):
        raise BuiltinError(f"{fn}: headers must carry a string alg")
    h = _b64url_nopad(_canon_json(headers).encode())
    p = _b64url_nopad(_canon_json(payload).encode())
    signed = f"{h}.{p}".encode()
    sig = _jwk_sign(alg, key, signed, fn)
    return f"{h}.{p}.{_b64url_nopad(sig)}"


def _bi_jwt_encode_sign_raw(headers, payload, key):
    """Like encode_sign but headers/payload/key arrive as JSON strings
    (topdown/tokens.go builtinJWTEncodeSignRaw)."""
    fn = "io.jwt.encode_sign_raw"
    try:
        hdr = freeze(json.loads(_need_str(headers, fn)))
        key_obj = freeze(json.loads(_need_str(key, fn)))
        json.loads(_need_str(payload, fn))  # must be valid JSON
    except ValueError as e:
        raise BuiltinError(f"{fn}: {e}") from None
    _need(hdr, "object", fn)
    alg = hdr.get("alg")
    if not isinstance(alg, str):
        raise BuiltinError(f"{fn}: headers must carry a string alg")
    h = _b64url_nopad(_need_str(headers, fn).encode())
    p = _b64url_nopad(_need_str(payload, fn).encode())
    signed = f"{h}.{p}".encode()
    sig = _jwk_sign(alg, key_obj, signed, fn)
    return f"{h}.{p}.{_b64url_nopad(sig)}"


# ----------------------------------------------------- gated http.send

def _bi_http_send(req):
    """Outbound HTTP from policy (topdown/http.go). DISABLED unless
    GATEKEEPER_TPU_ENABLE_HTTP_SEND=1: admission policies phoning out
    add unbounded tail latency and an exfiltration channel, so the gate
    is explicit and the error says exactly how to open it."""
    import os as _os

    fn = "http.send"
    _need(req, "object", fn)
    if _os.environ.get("GATEKEEPER_TPU_ENABLE_HTTP_SEND") != "1":
        raise BuiltinError(
            f"{fn}: disabled (set GATEKEEPER_TPU_ENABLE_HTTP_SEND=1 to "
            "allow outbound HTTP from policies)")
    import urllib.error
    import urllib.request

    method = _need_str(req.get("method", "GET"), fn).upper()
    url = _need_str(req.get("url", ""), fn)
    if not url.startswith(("http://", "https://")):
        raise BuiltinError(f"{fn}: unsupported url {url!r}")
    body = None
    if "body" in req:
        body = _canon_json(req["body"]).encode()
    elif "raw_body" in req:
        body = _need_str(req["raw_body"], fn).encode()
    headers = {str(k): str(v)
               for k, v in (req.get("headers") or FrozenDict()).items()}
    timeout = _need_num(req.get("timeout", 5), fn)
    r = urllib.request.Request(url, data=body, headers=headers,
                               method=method)
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            raw = resp.read().decode("utf-8", "replace")
            status = resp.status
            resp_headers = {k.lower(): v for k, v in resp.headers.items()}
    except urllib.error.HTTPError as e:
        raw = e.read().decode("utf-8", "replace")
        status = e.code
        resp_headers = {k.lower(): v for k, v in e.headers.items()}
    except (urllib.error.URLError, OSError) as e:
        if req.get("raise_error", True):
            raise BuiltinError(f"{fn}: {e}") from None
        return freeze({"status_code": 0, "error": str(e)})
    out = {"status_code": status, "raw_body": raw,
           "headers": resp_headers}
    try:
        out["body"] = json.loads(raw)
    except ValueError:
        out["body"] = None
    return freeze(out)


# ------------------------------------------------------- small parity

def _bi_opa_runtime():
    """Deployment environment view (topdown/runtime.go): env + version.
    Commonly used to read env-injected configuration in policies."""
    import os as _os

    return freeze({"env": dict(_os.environ),
                   "version": "gatekeeper-tpu"})


def _bi_rego_parse_module(filename, src):
    """Parse rego source and return an AST summary (package path + rule
    names/kinds). OPA returns its own Go AST JSON marshal; this is the
    native AST's summary — documented divergence, same use cases
    (introspecting a module's shape from policy)."""
    fn = "rego.parse_module"
    from .parser import ParseError, parse_module as _parse

    try:
        mod = _parse(_need_str(src, fn), _need_str(filename, fn))
    except ParseError as e:
        raise BuiltinError(f"{fn}: {e}") from None
    return freeze({
        "package": {"path": ["data"] + list(mod.package)},
        "rules": [{"name": r.name, "kind": r.kind,
                   "default": bool(getattr(r, "is_default", False))}
                  for r in mod.rules],
    })


def _bi_minus(a, b):
    # '-' doubles as set difference (named form of the infix operator)
    if isinstance(a, frozenset) and isinstance(b, frozenset):
        return a - b
    return _need_num(a, "minus") - _need_num(b, "minus")


def _bi_div(a, b):
    d = _need_num(b, "div")
    if d == 0:
        raise BuiltinError("div: divide by zero")
    out = _need_num(a, "div") / d
    return int(out) if float(out).is_integer() else out


def _bi_rem(a, b):
    x, y = _need_num(a, "rem"), _need_num(b, "rem")
    if y == 0:
        raise BuiltinError("rem: modulo by zero")
    if not (float(x).is_integer() and float(y).is_integer()):
        raise BuiltinError("rem: modulo on floating-point number")
    return int(_math.fmod(int(x), int(y)))


def _bi_set_diff(a, b):
    _need(a, "set", "set_diff")
    _need(b, "set", "set_diff")
    return a - b


def _bi_set_and(a, b):
    _need(a, "set", "and")
    _need(b, "set", "and")
    return a & b


def _bi_set_or(a, b):
    _need(a, "set", "or")
    _need(b, "set", "or")
    return a | b


BUILTINS.update({
    ("time", "parse_ns"): _bi_time_parse_ns,
    ("time", "parse_duration_ns"): _bi_time_parse_duration_ns,
    ("time", "format"): _bi_time_format,
    ("net", "cidr_expand"): _bi_cidr_expand,
    ("net", "cidr_merge"): _bi_cidr_merge,
    ("net", "cidr_contains_matches"): _bi_cidr_contains_matches,
    ("net", "cidr_overlap"): lambda c, x: _cidr_contains_pair(
        c, x, "net.cidr_overlap"),  # deprecated alias of cidr_contains
    ("regex", "template_match"): _bi_regex_template_match,
    ("regex", "globs_match"): _bi_regex_globs_match,
    ("regex", "find_all_string_submatch_n"):
        _bi_regex_find_all_string_submatch_n,
    ("glob", "quote_meta"): _bi_glob_quote_meta,
    ("crypto", "x509", "parse_certificates"): _bi_x509_parse_certificates,
    **{("io", "jwt", f"verify_{fam}{bits}"):
       (lambda t, c, _a=f"{fam.upper()}{bits}": _jwt_verify_asym(t, c, _a))
       for fam in ("rs", "ps", "es") for bits in ("256", "384", "512")},
    **{("io", "jwt", f"verify_hs{bits}"):
       (lambda t, c, _a=f"HS{bits}": _jwt_verify_hs(t, c, _a))
       for bits in ("384", "512")},
    ("io", "jwt", "decode_verify"): _bi_jwt_decode_verify,
    ("io", "jwt", "encode_sign"): _bi_jwt_encode_sign,
    ("io", "jwt", "encode_sign_raw"): _bi_jwt_encode_sign_raw,
    ("http", "send"): _bi_http_send,
    ("opa", "runtime"): _bi_opa_runtime,
    ("rego", "parse_module"): _bi_rego_parse_module,
    ("set_diff",): _bi_set_diff,
    ("cast_null",): lambda v: _need(v, "null", "cast_null"),
    ("cast_object",): lambda v: _need(v, "object", "cast_object"),
    ("cast_set",): lambda v: _need(v, "set", "cast_set"),
    # named forms of the infix operators (callable in OPA)
    ("plus",): lambda a, b: _need_num(a, "plus") + _need_num(b, "plus"),
    ("minus",): _bi_minus,
    ("mul",): lambda a, b: _need_num(a, "mul") * _need_num(b, "mul"),
    ("div",): _bi_div,
    ("rem",): _bi_rem,
    ("eq",): rego_eq,
    ("gt",): lambda a, b: sort_key(a) > sort_key(b),
    ("gte",): lambda a, b: sort_key(a) >= sort_key(b),
    ("lt",): lambda a, b: sort_key(a) < sort_key(b),
    ("lte",): lambda a, b: sort_key(a) <= sort_key(b),
    ("and",): _bi_set_and,
    ("or",): _bi_set_or,
})

# decode_verify consults the wall clock when no "time" constraint is
# given: memoizing it would freeze token validity across requests (an
# expired JWT would keep admitting workloads)
NONDETERMINISTIC.update({("http", "send"), ("opa", "runtime"),
                         ("io", "jwt", "decode_verify")})
