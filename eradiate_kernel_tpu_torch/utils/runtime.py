"""Render-loop runtime services: progress, cooperative cancellation,
timeouts, checkpoints, phase profiling and logging (utils/runtime.py
counterpart).

Counterparts of Mitsuba's ProgressReporter (progress.h), Integrator::cancel
and its timeout (integrator.h), the SIGHUP partial develop (mitsuba.cpp)
and the profiler's scoped phases (profiler.h), mapped onto host callbacks
between the passes of the scan driver: a pass of ``samples_per_pass``
samples is the cancellation, progress and checkpoint boundary.

``scoped_phase`` is the port's one span primitive: every layer of the
render path (core/rng.py up to integrators.render) marks its work with it,
so this module imports nothing of the port at load time.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
import zipfile

import numpy as np
import torch


class ProgressReporter:
    """ETA progress line over render passes (progress.h analog)."""

    def __init__(self, label="Rendering", stream=None):
        self.label = label
        self.stream = stream or sys.stderr
        self.t0 = time.time()

    def update(self, done: float):
        done = min(max(done, 1e-6), 1.0)
        elapsed = time.time() - self.t0
        eta = elapsed * (1.0 - done) / done
        bar = "=" * int(32 * done)
        self.stream.write(f"\r{self.label}: [{bar:<32}] {done*100:5.1f}% "
                          f"(ETA {eta:5.1f}s)")
        if done >= 1.0:
            self.stream.write("\n")
        self.stream.flush()


class RenderController:
    """Cooperative cancellation + wall-clock timeout, checked between passes
    (Integrator::cancel / m_timeout). ``partial`` holds the last accumulated
    film so an interrupted render can still be developed (SIGHUP analog)."""

    def __init__(self, timeout=None):
        self.timeout = timeout
        self._stop = False
        self.t0 = time.time()
        self.partial = None

    def cancel(self):
        self._stop = True

    def should_stop(self) -> bool:
        if self._stop:
            return True
        return (self.timeout is not None
                and time.time() - self.t0 > self.timeout)


def render(scene, seed=0, spp=None, samples_per_pass=None, progress=False,
           controller: RenderController | None = None, develop_film=True,
           checkpoint_path=None):
    """``integrators.render`` (the scan driver) with progress, cancellation
    and timeout between passes: pass p renders the samples from
    p * samples_per_pass through ``integrators.render_wavefront`` and adds
    them to the film on the scene's device.

    ``checkpoint_path``: crash-resumable rendering. After every pass the
    film (copied to the host), the next pass's index and the render's
    identity (seed, spp, film size, samples_per_pass) are written to
    ``<path>.tmp`` and renamed atomically to ``<path>``; on start, a
    checkpoint of the same identity resumes from its pass, another one is
    ignored. A render that ran to its end removes its checkpoint."""
    from .. import integrators
    from ..films import N_BASE_CHANNELS, develop

    cfg = scene.config
    dev = scene.bsphere_center.device
    spp = spp or cfg.spp
    W, H = cfg.film_width, cfg.film_height
    cw, ch = cfg.crop_size if cfg.crop_size else (W, H)
    total = cw * ch * spp
    if samples_per_pass is None:
        samples_per_pass = min(total, 1 << 20)
    n_passes = -(-total // samples_per_pass)

    reporter = ProgressReporter() if progress else None
    film = torch.zeros(ch, cw, N_BASE_CHANNELS + integrators.n_aov(cfg),
                       device=dev)
    start_pass = 0

    ident = np.asarray([seed, spp, cw, ch, samples_per_pass], np.int64)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        try:
            data = np.load(checkpoint_path)
            if ((data["ident"] == ident).all()
                    and data["film"].shape == tuple(film.shape)):
                film = torch.as_tensor(data["film"], device=dev)
                start_pass = int(data["next_pass"])
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass  # unreadable/foreign checkpoint: start fresh

    for p in range(start_pass, n_passes):
        if controller is not None and controller.should_stop():
            break
        off = p * samples_per_pass
        n = min(samples_per_pass, total - off)
        film = film + integrators.render_wavefront(scene, off, n, seed, spp)
        if controller is not None:
            controller.partial = film
        if checkpoint_path is not None:
            tmp = checkpoint_path + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, film=film.cpu().numpy(), next_pass=p + 1,
                         ident=ident)
            os.replace(tmp, checkpoint_path)
        if reporter:
            reporter.update((p + 1) / n_passes)
    if (checkpoint_path is not None and os.path.exists(checkpoint_path)
            and not (controller is not None and controller.should_stop())):
        os.remove(checkpoint_path)  # completed: checkpoint no longer needed
    if not develop_film:
        return film
    return develop(film[..., :N_BASE_CHANNELS], cfg.variant.mode,
                   cfg.pixel_format)


# =============================================================================
# profiling phases (profiler.h ScopedPhase -> torch.profiler)
# =============================================================================

_profiler_enabled = torch._C._autograd._profiler_enabled


class scoped_phase:
    """A named span of the port's work (ProfilerPhase / ScopedPhase
    analog), as a context manager or, applied to a function, as a
    decorator that spans each call (``@scoped_phase("ert::bounce")``; the
    function keeps its name and signature).

    With no profiler active a span costs one flag check: it calls no
    ``record_function`` and so reaches no dispatcher. Under an active
    torch.profiler (``trace`` below, or any ``torch.profiler.profile``) it
    enters ``record_function(name)``: the span lands in the Kineto trace as
    a user annotation on the launching thread, on the device events' clock,
    so each kernel and each idle gap of the device can be put down to the
    innermost span that launched it. A span adds no host sync, no device
    operation and no allocation. The port names its spans ``ert::<layer>``
    (PERF.md, "Tracing")."""

    __slots__ = ("name", "_span")

    def __init__(self, name: str):
        self.name = name
        self._span = None

    def __enter__(self):
        if _profiler_enabled():
            self._span = torch.profiler.record_function(self.name)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        span, self._span = self._span, None
        if span is not None:
            span.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the CPU, and the card where there is one) and
    write a Chrome trace to ``log_dir/trace.json`` (the Profiler report
    analog). Yields the profiler. The trace holds the port's
    ``scoped_phase`` spans (``ert::render`` down to ``ert::rng``) beside
    the kernels they launched: open it in Perfetto (ui.perfetto.dev) or
    chrome://tracing to see which layer used the device and where it idled;
    ``perfbench/spans.py`` reduces it to device and idle seconds a span."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# =============================================================================
# logging (logger.h / appender.h / formatter.h analog)
# =============================================================================

TRACE, DEBUG, INFO, WARN, ERROR = 0, 1, 2, 3, 4
_LEVEL_NAMES = {TRACE: "TRACE", DEBUG: "DEBUG", INFO: "INFO",
                WARN: "WARN", ERROR: "ERROR"}


class DefaultFormatter:
    """'[time] [class] [level] message' line format (formatter.h
    DefaultFormatter)."""

    def format(self, level, cls, msg):
        ts = time.strftime("%H:%M:%S")
        tag = _LEVEL_NAMES.get(level, str(level))
        where = f" [{cls}]" if cls else ""
        return f"{ts} {tag}{where}: {msg}"


class StreamAppender:
    """Write formatted records to a stream (appender.h StreamAppender)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr

    def append(self, level, text):
        self.stream.write(text + "\n")
        try:
            self.stream.flush()
        except (OSError, ValueError):  # a closed or unflushable stream
            pass


class Logger:
    """Leveled logger with pluggable appender fan-out (logger.h): records
    at or above ``log_level`` go to every registered appender; ERROR raises
    (the reference's Throw-on-Error contract)."""

    def __init__(self, log_level=INFO, formatter=None):
        self.log_level = log_level
        self.formatter = formatter or DefaultFormatter()
        self._appenders = []

    def add_appender(self, appender):
        self._appenders.append(appender)

    def remove_appender(self, appender):
        self._appenders.remove(appender)

    def clear_appenders(self):
        self._appenders.clear()

    @property
    def appenders(self):
        return tuple(self._appenders)

    def log(self, level, msg, cls=None):
        if level >= self.log_level:
            text = self.formatter.format(level, cls, msg)
            for a in self._appenders:
                a.append(level, text)
        if level >= ERROR:
            raise RuntimeError(msg)

    def trace(self, msg, cls=None):
        self.log(TRACE, msg, cls)

    def debug(self, msg, cls=None):
        self.log(DEBUG, msg, cls)

    def info(self, msg, cls=None):
        self.log(INFO, msg, cls)

    def warn(self, msg, cls=None):
        self.log(WARN, msg, cls)

    def error(self, msg, cls=None):
        self.log(ERROR, msg, cls)


_logger = None


def logger() -> Logger:
    """The process-wide default logger, writing to stderr (Thread::logger
    analog)."""
    global _logger
    if _logger is None:
        _logger = Logger()
        _logger.add_appender(StreamAppender())
    return _logger
