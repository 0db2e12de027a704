"""Headless streamlit stand-in and the harness that drives the port's app.

Counterpart: ``rgnir_tpu/testing/fake_streamlit.py``, of which this is
the port's own copy. The reference's product surface is a Streamlit app
(process-images.py:993-1612); this module implements the subset of the
``st`` API that ``rgnir_torch.app.streamlit_app`` uses (widgets,
containers, ``session_state``, ``rerun``) and an :class:`AppHarness`
that scripts widget values and button clicks and records every rendered
element, in the spirit of ``streamlit.testing.v1.AppTest``.

Semantics kept from streamlit:

- a button returns True for exactly one script run after its click and
  False on any rerun it triggers;
- stateful widgets (checkbox, select, input) keep their scripted value
  across reruns;
- ``st.rerun()`` aborts the run and the script runs again;
- ``session_state`` persists across reruns and across ``run()`` calls on
  one harness (one harness is one browser session).

:meth:`AppHarness.run` puts a shim bound to its harness under
``streamlit`` in ``sys.modules`` for the run and restores what was there
after, so it lives beside the JAX package's shim (installed for good by
its tests) in one process; the app imports ``streamlit`` inside its
``main``.
"""

from __future__ import annotations

import sys
import types
from typing import Any, Callable, Dict, List, Optional, Sequence

_MISSING = object()


class RerunException(Exception):
    """Raised by st.rerun() to restart the script."""


class UploadedFile:
    """Scriptable stand-in for streamlit's UploadedFile."""

    def __init__(self, name: str, data: bytes):
        self.name = name
        self._data = data

    def getvalue(self) -> bytes:
        return self._data


class SessionState(dict):
    """dict with attribute access, like st.session_state."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            # real st.session_state: attr-style delete of a missing key
            # raises AttributeError (dict-style raises KeyError)
            raise AttributeError(key) from e


class _Secrets:
    """No secrets.toml: .get raises like the real thing."""

    def get(self, key: str, default: Any = None) -> Any:
        raise FileNotFoundError("No secrets files found")


class Block:
    """A container (st itself, a column, a tab, an expander, the
    sidebar): records elements into the shared app and resolves widget
    values from the harness script. Usable as a context manager."""

    def __init__(self, app: "AppHarness"):
        self._app = app

    def __enter__(self) -> "Block":
        return self

    def __exit__(self, *exc) -> None:
        pass

    # -- element recording -------------------------------------------------
    def _record(self, kind: str, value: Any = None, **kw) -> None:
        self._app.elements.append({"type": kind, "value": value, **kw})

    def set_page_config(self, **kw) -> None:
        self._record("page_config", kw)

    def header(self, body: Any) -> None:
        self._record("header", body)

    def subheader(self, body: Any) -> None:
        self._record("subheader", body)

    def write(self, body: Any) -> None:
        self._record("write", body)

    def markdown(self, body: Any) -> None:
        self._record("markdown", body)

    def caption(self, body: Any) -> None:
        self._record("caption", body)

    def info(self, body: Any) -> None:
        self._record("info", body)

    def warning(self, body: Any) -> None:
        self._record("warning", body)

    def error(self, body: Any) -> None:
        self._record("error", body)

    def success(self, body: Any) -> None:
        self._record("success", body)

    def metric(self, label: str, value: Any, delta: Any = None) -> None:
        self._record("metric", value, label=label, delta=delta)

    def image(self, img: Any, caption: Any = None, **kw) -> None:
        self._record("image", img, caption=caption)

    def dataframe(self, df: Any, **kw) -> None:
        self._record("dataframe", df)

    def progress(self, value: float = 0.0, text: Optional[str] = None):
        self._record("progress", value)

        class _Progress:
            def progress(self_inner, v: float, text: Optional[str] = None):
                pass

            def empty(self_inner) -> None:
                pass

        return _Progress()

    # -- containers ----------------------------------------------------------
    def columns(self, spec) -> List["Block"]:
        n = spec if isinstance(spec, int) else len(spec)
        return [Block(self._app) for _ in range(n)]

    def tabs(self, names: Sequence[str]) -> List["Block"]:
        return [Block(self._app) for _ in names]

    def expander(self, label: str, expanded: bool = False) -> "Block":
        return Block(self._app)

    def container(self) -> "Block":
        return Block(self._app)

    def form(self, key: str) -> "Block":
        return Block(self._app)

    @property
    def sidebar(self) -> "Block":
        return Block(self._app)

    # -- widgets ---------------------------------------------------------------
    def _value(self, key: Optional[str], label: str, default: Any) -> Any:
        got = self._app._lookup(key, label)
        return default if got is _MISSING else got

    def button(self, label: str, key: Optional[str] = None,
               disabled: bool = False, **kw) -> bool:
        if disabled:
            return False
        return self._app._consume_click(key or label)

    def form_submit_button(self, label: str = "Submit", **kw) -> bool:
        return self._app._consume_click(label)

    def download_button(self, label: str, data: Any,
                        file_name: Optional[str] = None, **kw) -> bool:
        self._record("download_button", data, label=label,
                     file_name=file_name)
        return False

    def checkbox(self, label: str, value: bool = False,
                 key: Optional[str] = None, **kw) -> bool:
        return bool(self._value(key, label, value))

    def text_input(self, label: str, value: str = "",
                   key: Optional[str] = None, **kw) -> str:
        return self._value(key, label, value)

    def text_area(self, label: str, value: str = "",
                  key: Optional[str] = None, **kw) -> str:
        return self._value(key, label, value)

    def number_input(self, label: str, min_value: Any = None,
                     max_value: Any = None, value: Any = None,
                     key: Optional[str] = None, **kw) -> Any:
        if value is None:
            value = min_value if min_value is not None else 0.0
        out = self._value(key, label, value)
        if min_value is not None and out < min_value:
            raise ValueError(f"{label}: {out} < min {min_value}")
        if max_value is not None and out > max_value:
            raise ValueError(f"{label}: {out} > max {max_value}")
        return out

    def selectbox(self, label: str, options: Sequence,
                  index: int = 0, key: Optional[str] = None,
                  format_func: Callable = str, **kw) -> Any:
        options = list(options)
        got = self._app._lookup(key, label)
        if got is _MISSING:
            return options[index] if options else None
        return got(options) if callable(got) else got

    def multiselect(self, label: str, options: Sequence,
                    default: Optional[Sequence] = None,
                    key: Optional[str] = None,
                    format_func: Callable = str, **kw) -> List:
        got = self._app._lookup(key, label)
        if got is _MISSING:
            return list(default) if default else []
        return list(got(list(options))) if callable(got) else list(got)

    def file_uploader(self, label: str, type: Optional[Sequence] = None,
                      accept_multiple_files: bool = False,
                      key: Optional[str] = None, **kw):
        got = self._app._lookup(key, label)
        if got is _MISSING:
            return [] if accept_multiple_files else None
        return got

    # -- control flow -----------------------------------------------------------
    def rerun(self) -> None:
        raise RerunException()

    @property
    def session_state(self) -> SessionState:
        return self._app.state

    @property
    def secrets(self) -> _Secrets:
        return _Secrets()


class AppHarness:
    """Drives an app function headlessly across reruns.

    >>> h = AppHarness(app.main)
    >>> h.set("Site Name", "Field A")
    >>> h.click("Create Site")
    >>> h.run()
    >>> h.values("success")
    ["Site 'Field A' created successfully!"]
    """

    MAX_RERUNS = 16

    def __init__(self, app_fn: Callable[[], None]):
        self.app_fn = app_fn
        self.state = SessionState()
        self.inputs: Dict[str, Any] = {}
        self.elements: List[Dict] = []
        self._pending_clicks: set = set()
        self._active_clicks: set = set()

    # -- scripting ------------------------------------------------------------
    def set(self, key_or_label: str, value: Any) -> "AppHarness":
        """Script a stateful widget's value (persists across runs).
        ``value`` may be a callable: multiselect/selectbox call it with
        their options list so tests can pick objects they can't name."""
        self.inputs[key_or_label] = value
        return self

    def unset(self, key_or_label: str) -> "AppHarness":
        self.inputs.pop(key_or_label, None)
        return self

    def click(self, key_or_label: str) -> "AppHarness":
        """Queue a button click for the next run() (consumed by it)."""
        self._pending_clicks.add(key_or_label)
        return self

    # -- resolution (called by Block) ----------------------------------------
    def _lookup(self, key: Optional[str], label: str) -> Any:
        if key is not None and key in self.inputs:
            return self.inputs[key]
        if label in self.inputs:
            return self.inputs[label]
        return _MISSING

    def _consume_click(self, name: str) -> bool:
        return name in self._active_clicks

    # -- execution ---------------------------------------------------------------
    def run(self) -> "AppHarness":
        """Run the app until it settles, with this harness's shim as
        ``streamlit`` in ``sys.modules`` (what was there is put back)."""
        saved = sys.modules.get("streamlit", _MISSING)
        sys.modules["streamlit"] = _StModule(self)
        try:
            self._active_clicks = set(self._pending_clicks)
            self._pending_clicks = set()
            for _ in range(self.MAX_RERUNS):
                self.elements = []
                try:
                    self.app_fn()
                    return self
                except RerunException:
                    # buttons revert to False on the triggered rerun
                    self._active_clicks = set()
            raise RuntimeError(f"app did not settle in {self.MAX_RERUNS} reruns")
        finally:
            if saved is _MISSING:
                sys.modules.pop("streamlit", None)
            else:
                sys.modules["streamlit"] = saved

    # -- inspection ------------------------------------------------------------
    def values(self, kind: str) -> List[Any]:
        return [e["value"] for e in self.elements if e["type"] == kind]

    def by_type(self, kind: str) -> List[Dict]:
        return [e for e in self.elements if e["type"] == kind]


class _StModule(types.ModuleType):
    """The ``streamlit`` module of one harness: its API is the harness's
    root block's."""

    def __init__(self, app: AppHarness):
        super().__init__("streamlit")
        self.__fake__ = True
        self._root = Block(app)

    def __getattr__(self, name: str) -> Any:
        try:
            return getattr(self.__dict__["_root"], name)
        except AttributeError:
            raise AttributeError(f"fake_streamlit has no st.{name}") from None
