"""Asynchronous processor runtime.

Re-creation of the observer/progress/abort protocol the reference obtains from
the external ``de.sciss.processor`` library (reference SURVEY layer L3; used
via ``ProcessorImpl``/``ProcessorFactory`` throughout, e.g.
FeatureCorrelationImpl.scala:28, Strugatzki.scala:95-99):

* ``factory.run(config, observer)`` returns a started :class:`Processor`
  (a future-like handle) and feeds the observer with :class:`Progress` and
  :class:`Result` events.
* ``progress`` is a float in ``[0, 1]``.
* ``abort()`` requests cooperative cancellation; processor bodies poll
  :meth:`Processor.check_aborted` inside their loops and raise
  :class:`Aborted`.
* ``await``-ing a processor blocks until completion
  (reference Strugatzki.scala:98 ``Await.ready``).

Each processor body runs on its own dedicated thread, matching the reference's
threading model (reference README.md:83: one dedicated thread per process) —
in this JAX rebuild the heavy lifting inside a body is a handful of big jitted
XLA launches, so a plain thread is the right amount of runtime.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Generic, Optional, TypeVar

__all__ = [
    "Aborted",
    "Progress",
    "Result",
    "Processor",
    "ProcessorFactory",
    "run_blocking",
]

T = TypeVar("T")


class Aborted(Exception):
    """Raised inside a processor body when :meth:`Processor.abort` was called.

    Mirrors the reference's ``Processor.Aborted()`` failure case
    (Strugatzki.scala:200-204).
    """


@dataclass(frozen=True)
class Progress:
    """Progress event: fraction ``[0, 1]`` of work done."""

    processor: "Processor"
    fraction: float


@dataclass(frozen=True)
class Result:
    """Terminal event: either ``value`` is set or ``failure`` is an exception."""

    processor: "Processor"
    value: Any = None
    failure: Optional[BaseException] = None

    @property
    def is_success(self) -> bool:
        return self.failure is None

    @property
    def is_aborted(self) -> bool:
        return isinstance(self.failure, Aborted)


Observer = Callable[[Any], None]


class Processor(Generic[T]):
    """A cancellable, progress-reporting computation running on its own thread."""

    def __init__(self, body: Callable[["Processor"], T], name: str = "processor",
                 observer: Optional[Observer] = None) -> None:
        self._body = body
        self.name = name
        self._observer = observer
        self._aborted = threading.Event()
        self._done = threading.Event()
        self._result: Optional[Result] = None
        self._progress = 0.0
        self._on_complete: list = []
        self._on_failure: list = []
        # guards the registration-vs-snapshot race: once _run has taken its
        # hook snapshot (under this lock), late registrations fire
        # immediately instead of landing in a list nobody reads again
        self._hook_lock = threading.Lock()
        self._hooks_taken = False
        # weighted sub-progress support (reference ProcessorImpl.await(child, weight))
        self._progress_base = 0.0
        self._progress_weight = 1.0
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)

    # -- lifecycle -----------------------------------------------------------------

    def start(self) -> "Processor[T]":
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            value = self._body(self)
            self._result = Result(self, value=value)
        except BaseException as e:  # noqa: BLE001 - must surface any failure
            self._result = Result(self, failure=e)
        finally:
            # cleanup hooks, mirroring the reference's onFailure/onComplete
            # temp-file lifecycle (NonRealtimeProcessor.scala:50-55)
            with self._hook_lock:
                hooks = list(self._on_complete)
                if self._result.failure is not None:
                    hooks += list(self._on_failure)
                self._hooks_taken = True
            for h in hooks:
                try:
                    h(self._result)
                except Exception:  # noqa: BLE001 - hooks must not mask results
                    pass
            # dispatch the Result BEFORE releasing ready()/result() waiters
            # so observers always saw the event by the time waiters wake
            self._dispatch(self._result)
            self._done.set()

    def on_complete(self, hook: Callable[[Result], None]) -> None:
        """Run ``hook`` at termination (success or failure).  Registered on
        an already-completed processor, the hook fires immediately (like a
        callback on a completed Future — the reference's onComplete
        semantics); without this a fast-failing body would race
        registration and silently drop cleanup."""
        with self._hook_lock:
            if not self._hooks_taken:
                self._on_complete.append(hook)
                return
        try:
            hook(self._result)
        except Exception:  # noqa: BLE001 - hooks must not mask results
            pass

    def on_failure(self, hook: Callable[[Result], None]) -> None:
        """Run ``hook`` only on failure/abort (immediately when already
        completed with a failure — see :meth:`on_complete`)."""
        with self._hook_lock:
            if not self._hooks_taken:
                self._on_failure.append(hook)
                return
        if self._result.failure is not None:
            try:
                hook(self._result)
            except Exception:  # noqa: BLE001
                pass

    def _dispatch(self, event: Any) -> None:
        if self._observer is not None:
            try:
                self._observer(event)
            except Exception:  # noqa: BLE001 - observers must not kill the body
                pass

    # -- abort protocol --------------------------------------------------------------

    def abort(self) -> None:
        """Request cooperative cancellation."""
        self._aborted.set()

    def check_aborted(self) -> None:
        """Raise :class:`Aborted` if :meth:`abort` was called.

        Processor bodies call this inside their hot loops, mirroring the
        reference's ``checkAborted()`` polling (FeatureCorrelationImpl.scala:164).
        """
        if self._aborted.is_set():
            raise Aborted()

    # -- progress ----------------------------------------------------------------------

    @property
    def progress(self) -> float:
        return self._progress

    @progress.setter
    def progress(self, fraction: float) -> None:
        self.set_progress(fraction)

    def set_progress(self, fraction: float) -> None:
        f = self._progress_base + self._progress_weight * float(fraction)
        self._progress = f
        self._dispatch(Progress(self, f))

    def sub(self, weight: float):
        """Context manager scaling nested progress into ``weight`` of the
        WHOLE (of the enclosing scope's weight), anchored at the current
        progress — exactly the reference's ``await(childProcessor, weight)``
        weighting (NonRealtimeProcessor.scala:158: NRT render = 80% then
        stitch = 20%, each a fraction of the whole, entered sequentially).
        Weights must therefore tile the remaining progress budget: a body
        at progress 0.5 entering ``sub(0.8)`` would report up to 1.3 —
        like the reference, nothing clamps to 1 (its segmentation progress
        famously runs backwards, SURVEY §5); callers pick weights that sum
        with the progress already reported.
        """
        proc = self

        class _Sub:
            def __enter__(self):
                self._saved = (proc._progress_base, proc._progress_weight)
                proc._progress_base = proc._progress
                proc._progress_weight = weight * self._saved[1]
                return proc

            def __exit__(self, *exc):
                proc._progress_base, proc._progress_weight = self._saved
                return False

        return _Sub()

    # -- future interface ---------------------------------------------------------------

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> T:
        """Block until completion; return the product or raise the failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"processor {self.name!r} still running")
        assert self._result is not None
        if self._result.failure is not None:
            raise self._result.failure
        return self._result.value

    def ready(self, timeout: Optional[float] = None) -> Result:
        """Block until completion; return the terminal :class:`Result` event."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"processor {self.name!r} still running")
        assert self._result is not None
        return self._result


class ProcessorFactory(Generic[T]):
    """Base for the six analysis factories.

    Subclasses define ``name``, a ``Config`` type and ``_make_body(config)``;
    ``run(config, observer)`` starts the processor, mirroring the reference's
    ``ProcessorFactory.run(config)(observer)`` (e.g. FeatureExtraction.scala:25-34).

    The classvar ``verbose`` mirrors the reference's per-factory ``var verbose``
    flags (FeatureCorrelation.scala:28 etc.).
    """

    name: str = "processor"
    verbose: bool = False

    @classmethod
    def _make_body(cls, config: Any) -> Callable[[Processor], T]:
        raise NotImplementedError

    @classmethod
    def run(cls, config: Any, observer: Optional[Observer] = None) -> Processor[T]:
        body = cls._make_body(config)
        return Processor(body, name=cls.name, observer=observer).start()


def run_blocking(factory: "type[ProcessorFactory[T]]", config: Any,
                 observer: Optional[Observer] = None) -> T:
    """Run a factory's processor to completion on the calling thread's behalf."""
    proc = factory.run(config, observer)
    return proc.result()
