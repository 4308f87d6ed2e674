"""The ctypes signatures of the port's kernel library against its sources.

``ops/_build.py`` declares every C function's argument types in
``_SIGNATURES``; ctypes passes an undeclared or mis-declared pointer as a
32-bit int and cuts it without a word. This test reads each ``extern "C"``
function of ``ops/csrc/*.cu`` and holds its parameters, one by one, against
the declaration. No compiler is needed.
"""

import ctypes
import os
import re

import pytest

from distributed_pipeline_tpu_torch.ops import _build

_DEF = re.compile(r"^([A-Za-z_][\w \*]*?)\s*\b(dpt_\w+)\(([^)]*)\)\s*\{",
                  re.M)


def _ctype(decl: str):
    """The ctypes type a C parameter or return type must be declared as."""
    decl = " ".join(decl.split())
    if decl.startswith("const char*") or decl == "const char *":
        return ctypes.c_char_p
    if "*" in decl:
        return ctypes.c_void_p
    base = re.sub(r"\s*\b\w+$", "", decl) or decl
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[base]


def _c_functions():
    found = {}
    for src in _build._SOURCES:
        with open(src) as f:
            text = f.read()
        start = text.index('extern "C" {')
        for ret, name, params in _DEF.findall(text[start:]):
            args = [p.strip() for p in params.split(",") if p.strip()]
            found[name] = (os.path.basename(src), ret, args)
    return found


def test_every_c_function_has_a_matching_signature():
    funcs = _c_functions()
    assert set(funcs) == set(_build._SIGNATURES), (
        "C functions and _SIGNATURES differ: "
        f"{sorted(set(funcs) ^ set(_build._SIGNATURES))}")
    assert {"dpt_flash_fwd", "dpt_flash_bwd", "dpt_flash_decode",
            "dpt_fused_update", "dpt_error_string"} <= set(funcs)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_parameters_match_one_by_one(name):
    src, ret, params = _c_functions()[name]
    argtypes, restype = _build._SIGNATURES[name]
    assert len(argtypes) == len(params), (
        f"{src}:{name} takes {len(params)} parameters, _SIGNATURES "
        f"declares {len(argtypes)}")
    for i, (param, declared) in enumerate(zip(params, argtypes)):
        assert declared is _ctype(param), (
            f"{src}:{name} parameter {i} `{param}` is declared as "
            f"{declared.__name__}")
    assert restype is _ctype(ret)
