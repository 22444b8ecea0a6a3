"""Time spans in sample frames.

JAX re-implementation of the subset of ``de.sciss.span.Span`` that the
reference framework uses (see reference impl/SpanUtil.scala:21-43 and the
``Span.NonVoid`` usages across the six analysis modules).

A span may be closed (``Span(start, stop)``), half-open (``Span.from_(start)``
/ ``Span.until(stop)``) or fully open (``Span.all()``).  All positions are
sample frames of the underlying *audio* file (not feature frames).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional
import xml.etree.ElementTree as ET

__all__ = ["Span", "span_from_xml", "span_to_xml", "spacing"]


@dataclass(frozen=True)
class Span:
    """A (possibly open) span ``[start, stop)`` in sample frames.

    ``start is None`` means the span extends from the beginning;
    ``stop is None`` means it extends to the end.  ``Span.all()`` has both
    open.  This single class covers the reference's ``Span``, ``Span.From``,
    ``Span.Until`` and ``Span.All`` cases (``Span.NonVoid``).
    """

    start: Optional[int] = None
    stop: Optional[int] = None

    # -- constructors matching the reference naming --------------------------------

    @staticmethod
    def all() -> "Span":
        return Span(None, None)

    @staticmethod
    def from_(start: int) -> "Span":
        return Span(int(start), None)

    @staticmethod
    def until(stop: int) -> "Span":
        return Span(None, int(stop))

    @staticmethod
    def closed(start: int, stop: int) -> "Span":
        return Span(int(start), int(stop))

    # -- queries --------------------------------------------------------------------

    @property
    def is_all(self) -> bool:
        return self.start is None and self.stop is None

    @property
    def has_start(self) -> bool:
        return self.start is not None

    @property
    def has_stop(self) -> bool:
        return self.stop is not None

    @property
    def is_closed(self) -> bool:
        return self.start is not None and self.stop is not None

    @property
    def length(self) -> int:
        """Length of a closed span (``stop - start``); raises otherwise."""
        if not self.is_closed:
            raise ValueError(f"length undefined for open span {self!r}")
        return self.stop - self.start  # type: ignore[operator]

    @property
    def non_empty(self) -> bool:
        if self.is_closed:
            return self.stop > self.start  # type: ignore[operator]
        return True

    def __repr__(self) -> str:  # pragma: no cover - debug helper
        if self.is_all:
            return "Span.all"
        if self.start is None:
            return f"Span.until({self.stop})"
        if self.stop is None:
            return f"Span.from_({self.start})"
        return f"Span({self.start}, {self.stop})"


def span_from_xml(elem: Optional[ET.Element]) -> Span:
    """Parse ``<start>``/``<stop>`` children into a span.

    Mirrors reference impl/SpanUtil.scala:21-30 (absent tags yield open ends,
    both absent yields ``Span.all``).  ``elem`` may be ``None`` (no ``<span>``
    element present at all), which also yields ``Span.all``.
    """
    if elem is None:
        return Span.all()
    start_el = elem.find("start")
    stop_el = elem.find("stop")
    start = int(start_el.text) if start_el is not None and start_el.text else None
    stop = int(stop_el.text) if stop_el is not None and stop_el.text else None
    return Span(start, stop)


def span_to_xml(span: Span, parent: ET.Element) -> None:
    """Append ``<start>``/``<stop>`` children for the defined ends.

    Mirrors reference impl/SpanUtil.scala:32-36 (open ends are omitted).
    """
    if span.start is not None:
        ET.SubElement(parent, "start").text = str(span.start)
    if span.stop is not None:
        ET.SubElement(parent, "stop").text = str(span.stop)


def spacing(a: Span, b: Span) -> int:
    """Gap between two closed spans; negative if they overlap.

    Mirrors reference impl/SpanUtil.scala:38-43.
    """
    if a.start < b.start:  # type: ignore[operator]
        return b.start - a.stop  # type: ignore[operator]
    return a.start - b.stop  # type: ignore[operator]
