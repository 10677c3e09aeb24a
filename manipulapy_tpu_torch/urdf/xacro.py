"""Xacro preprocessing: external tool when present, native fallback.

Counterpart of ``manipulapy_tpu/urdf/xacro.py``, the same code.

Capability parity with the reference's ``ManipulaPy/urdf/xacro.py``
(``XacroProcessor``, 283 LoC): shells out to the ``xacro`` executable if
installed; otherwise runs a native subset processor covering the common
constructs — ``xacro:property``, ``${...}`` expression substitution
(Python-evaluated with a restricted namespace), ``xacro:macro`` +
instantiation with parameters, and ``xacro:include`` of local files.
"""

from __future__ import annotations

import math
import os
import re
import shutil
import subprocess
import xml.etree.ElementTree as ET
from typing import Dict, Optional

__all__ = ["XacroProcessor", "process_xacro"]

_XACRO_NS = "http://www.ros.org/wiki/xacro"
_EXPR_RE = re.compile(r"\$\{([^}]*)\}")

# Restricted eval namespace for ${...} expressions (the xacro convention).
_EVAL_GLOBALS = {"__builtins__": {}, "pi": math.pi, "sin": math.sin, "cos": math.cos,
                 "tan": math.tan, "sqrt": math.sqrt, "abs": abs, "min": min, "max": max,
                 "radians": math.radians, "degrees": math.degrees}


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _is_xacro(tag: str) -> bool:
    return tag.startswith("{" + _XACRO_NS + "}") or _strip_ns(tag).startswith("xacro:")


class XacroProcessor:
    """``.xacro`` -> URDF XML (reference ``xacro.py:39-271``)."""

    def __init__(self, prefer_external: bool = True):
        self.prefer_external = prefer_external

    def process_file(self, path: str, mappings: Optional[Dict[str, str]] = None) -> str:
        if self.prefer_external and shutil.which("xacro"):
            cmd = ["xacro", path] + [f"{k}:={v}" for k, v in (mappings or {}).items()]
            try:
                out = subprocess.run(
                    cmd, capture_output=True, text=True, timeout=60, check=True
                )
                return out.stdout
            except (subprocess.SubprocessError, OSError):
                pass  # fall through to the native subset processor
        with open(path, "r", encoding="utf-8") as f:
            return self.process_string(f.read(), mappings, base_dir=os.path.dirname(path))

    def process_string(
        self,
        content: str,
        mappings: Optional[Dict[str, str]] = None,
        base_dir: Optional[str] = None,
    ) -> str:
        root = ET.fromstring(content)
        props: Dict[str, str] = dict(mappings or {})
        macros: Dict[str, ET.Element] = {}
        self._collect(root, props, macros, base_dir)
        out = self._expand(root, props, macros)
        # Drop xmlns:xacro declarations that ElementTree carried through.
        xml = ET.tostring(out, encoding="unicode")
        return re.sub(r'\s+xmlns:ns\d+="[^"]*"', "", xml)

    # -- passes -----------------------------------------------------------------

    def _collect(self, el: ET.Element, props, macros, base_dir) -> None:
        """Gather properties/macros and inline includes, depth-first."""
        for child in list(el):
            tag = _strip_ns(child.tag)
            if _is_xacro(child.tag) and tag == "property":
                name = child.get("name", "")
                if name and name not in props:  # mappings take precedence
                    props[name] = child.get("value", "")
                el.remove(child)
            elif _is_xacro(child.tag) and tag == "macro":
                macros[child.get("name", "")] = child
                el.remove(child)
            elif _is_xacro(child.tag) and tag == "include":
                fname = child.get("filename", "")
                if base_dir and not os.path.isabs(fname):
                    fname = os.path.join(base_dir, fname)
                sub = ET.fromstring(open(fname, "r", encoding="utf-8").read())
                idx = list(el).index(child)
                el.remove(child)
                for off, grand in enumerate(list(sub)):
                    el.insert(idx + off, grand)
                self._collect(el, props, macros, os.path.dirname(fname))
                return  # restart: the child list changed
            else:
                self._collect(child, props, macros, base_dir)

    def _subst(self, text: str, props: Dict[str, str]) -> str:
        def repl(m: re.Match) -> str:
            expr = m.group(1).strip()
            ns = dict(_EVAL_GLOBALS)
            for k, v in props.items():
                try:
                    ns[k] = float(v)
                except (TypeError, ValueError):
                    ns[k] = v
            try:
                val = eval(expr, ns)  # noqa: S307 - restricted namespace
            except Exception:
                return props.get(expr, m.group(0))
            if isinstance(val, float) and val.is_integer():
                return str(int(val))
            return str(val)

        return _EXPR_RE.sub(repl, text)

    def _expand(self, el: ET.Element, props, macros) -> ET.Element:
        tag = _strip_ns(el.tag)
        if _is_xacro(el.tag) and tag in macros:
            raise AssertionError("macro instantiation handled by parent")
        new = ET.Element(_strip_ns(el.tag) if not _is_xacro(el.tag) else el.tag)
        for k, v in el.attrib.items():
            new.set(k, self._subst(v, props))
        if el.text:
            new.text = self._subst(el.text, props)
        for child in el:
            ctag = _strip_ns(child.tag)
            if _is_xacro(child.tag) and ctag in macros:
                macro = macros[ctag]
                params = {
                    p: self._subst(child.get(p, ""), props)
                    for p in macro.get("params", "").split()
                    if p
                }
                scope = {**props, **params}
                for grand in macro:
                    new.append(self._expand(grand, scope, macros))
            elif _is_xacro(child.tag) and ctag == "if":
                cond = self._subst(child.get("value", "0"), props)
                if cond.strip().lower() in ("1", "true"):
                    for grand in child:
                        new.append(self._expand(grand, props, macros))
            elif _is_xacro(child.tag) and ctag == "unless":
                cond = self._subst(child.get("value", "0"), props)
                if cond.strip().lower() not in ("1", "true"):
                    for grand in child:
                        new.append(self._expand(grand, props, macros))
            else:
                new.append(self._expand(child, props, macros))
        return new


def process_xacro(path_or_string: str, mappings: Optional[Dict[str, str]] = None) -> str:
    """Process a ``.xacro`` file path or an XML string."""
    proc = XacroProcessor()
    if "\n" not in path_or_string and os.path.exists(path_or_string):
        return proc.process_file(path_or_string, mappings)
    return proc.process_string(path_or_string, mappings)
