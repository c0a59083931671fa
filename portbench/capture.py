"""What the timed path produces at the steps the check judges.

A DMC or VMC run's steps leave no trace outside the sampler but the
block's sums and the last state, and a Monte Carlo trajectory cannot be
followed from its start by another implementation: one comb decision or
Metropolis test that falls the other way on rounding sends the two runs
apart.  So the check follows the program one step at a time from the
program's own state.  :class:`StepCapture` wraps the samplers' per-step
methods for the window's call and keeps, at a few steps drawn from the
seed (the window's first and last and one between), what went in and
what came out: the walker state before and after, the comb's parents,
and what the step handed its estimators and got back.

The sampler methods it wraps are ``Sampling._step`` and, on measuring
steps, ``Sampling._estimate`` (DMC) or ``Sampling._measure`` (VMC, one
estimator step every ``est_every`` steps), each called once per step with
a leading row axis of 1.  These are the program's private methods, so
the capture checks their parameters when it is installed and raises
:class:`CaptureError`, naming the method, where they are not those it
reads.  Records are copied to the host at once, so that holding them
takes no device memory; at the window's last step, after which nothing
runs, the large ITC tensors are kept where they are.
"""
import inspect

import torch

__all__ = ["CaptureError", "StepCapture", "checked_steps"]

_ITC_AUX = ("aux_itc", "aux_itc_cnt")
#: The parameters the capture reads of each method it wraps, in order:
#: all of them, or (``_step``) the first.
SIGNATURES = {
    "_step": ("self", "state"),
    "_estimate": ("self", "consts", "aux", "perm", "itc_perm", "branch",
                  "state", "step_idx"),
    "_measure": ("self", "consts", "pos", "chunk"),
}


class CaptureError(RuntimeError):
    """The program's step methods are no longer those the check reads."""


def checked_steps(seed: int, total: int) -> list:
    """The window's first and last steps and one between, drawn from the
    seed."""
    if total <= 2:
        return list(range(total))
    gen = torch.Generator().manual_seed(int(seed) % (1 << 62))
    mid = 1 + int(torch.randint(total - 2, (1,), generator=gen))
    return [0, mid, total - 1]


def _row(x, host: bool):
    """Row 0 of a rows tensor, on the host where ``host``."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x[0].detach()
    return x.to("cpu") if host else x


def _fields(state, host: bool, skip=("itc_buf",)) -> dict:
    return {name: _row(value, host) for name, value in state._asdict().items()
            if name not in skip and value is not None}


class StepCapture:
    """Wraps ``sampler_cls``'s step methods while it is installed (a
    ``with`` block around the window's call) and records the steps
    ``checked`` of the ``total`` the window runs."""

    def __init__(self, sampler_cls, kind: str, checked, total: int):
        self.cls = sampler_cls
        self.kind = kind
        self.checked = frozenset(checked)
        self.last = total - 1
        self.count = 0
        self.current = -1
        self.records = {}
        self._saved = {}

    def _method(self, name: str):
        """The class's own ``name``, with the parameters the capture
        reads."""
        where = f"{self.cls.__module__}.{self.cls.__name__}.{name}"
        fn = self.cls.__dict__.get(name)
        if fn is None:
            raise CaptureError(f"{where} is gone: the check records the "
                               "window's steps through it")
        want = SIGNATURES[name]
        have = tuple(inspect.signature(fn).parameters)
        if have[:len(want)] != want or (name != "_step"
                                        and have != want):
            raise CaptureError(
                f"{where} takes {have}, where the check reads {want}: "
                "portbench/capture.py has to follow the program's step")
        return fn

    def __enter__(self):
        names = ("_step", "_estimate") if self.kind == "dmc" \
            else ("_step", "_measure")
        for name in names:
            self._saved[name] = self._method(name)
        self.cls._step = self._wrap_step(self._saved["_step"])
        if self.kind == "dmc":
            self.cls._estimate = self._wrap_estimate(self._saved["_estimate"])
        else:
            self.cls._measure = self._wrap_measure(self._saved["_measure"])
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.cls, name, fn)
        return False

    def _wrap_step(self, step):
        capture = self

        def wrapped(sampling, state, *args, **kwargs):
            k = capture.count
            capture.count += 1
            capture.current = k
            out = step(sampling, state, *args, **kwargs)
            if k in capture.checked:
                capture._record_step(k, state, out)
            return out

        return wrapped

    def _record_step(self, k: int, state, out):
        if self.kind == "dmc":
            if not (isinstance(out, tuple) and len(out) == 3):
                raise CaptureError(
                    f"{self.cls.__name__}._step returned "
                    f"{type(out).__name__}, where the check reads "
                    "(state, e_prev_slots, branch)")
            new_state, _, branch = out
            record = {"in": _fields(state, True), "out": _fields(new_state,
                                                                 True),
                      "parent": _row(branch.parent, True)}
        else:
            record = {"in": _fields(state, True, ()),
                      "out": _fields(out, True, ())}
        self.records[k] = record

    def _wrap_estimate(self, estimate):
        capture = self
        signature = inspect.signature(estimate)

        def wrapped(sampling, *args, **kwargs):
            k = capture.current
            if k not in capture.checked:
                return estimate(sampling, *args, **kwargs)
            given = signature.bind(sampling, *args, **kwargs).arguments
            aux, perm, itc_perm, state, step_idx = (
                given[name] for name in ("aux", "perm", "itc_perm", "state",
                                         "step_idx"))
            aux_in = dict(aux or {})
            buf_in, filled_in = state.itc_buf, state.itc_filled
            new_aux, rows, new_state = estimate(sampling, *args, **kwargs)
            if k not in capture.records:
                raise CaptureError(
                    f"{capture.cls.__name__}._estimate ran at step {k} "
                    "before its _step had returned: the check reads the "
                    "step's children from _step")
            host = k != capture.last
            itc = "itc" in rows
            capture.records[k]["est"] = {
                "step_idx": int(step_idx),
                "aux": {name: _row(value, host)
                        for name, value in aux_in.items()
                        if itc or name not in _ITC_AUX},
                "perm": _row(perm, True),
                "itc_perm": _row(itc_perm, host) if itc else None,
                "itc_buf": _row(buf_in, host) if itc else None,
                "itc_filled": _row(filled_in, True) if itc else None,
                "rows": {name: _row(value, True)
                         for name, value in rows.items()},
                "itc_buf_out": (_row(new_state.itc_buf, host)
                                if itc else None),
                "itc_filled_out": (_row(new_state.itc_filled, True)
                                   if itc else None)}
            return new_aux, rows, new_state

        return wrapped

    def _wrap_measure(self, measure):
        capture = self

        def wrapped(sampling, *args, **kwargs):
            rows = measure(sampling, *args, **kwargs)
            k = capture.current
            if k in capture.checked:
                if k not in capture.records:
                    raise CaptureError(
                        f"{capture.cls.__name__}._measure ran at step {k} "
                        "before its _step had returned")
                capture.records[k]["rows"] = {
                    name: _row(value, True) for name, value in rows.items()}
            return rows

        return wrapped
