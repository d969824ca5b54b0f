"""Heuristic SIMPLE/COMPLEX query router.

Behavioral invariant of the reference (main.py:201-206, main2.py:156-158):
a query is COMPLEX when it exceeds 20 words or mentions any analysis
keyword; COMPLEX routes to the large LLM tier, SIMPLE to the fast one.
"""

from __future__ import annotations

COMPLEX_KEYWORDS = ("compare", "analyze", "why", "impact", "trends", "growth", "risk")

SIMPLE = "SIMPLE"
COMPLEX = "COMPLEX"


def route_query(query: str) -> str:
    q = query.lower()
    if len(query.split()) > 20 or any(kw in q for kw in COMPLEX_KEYWORDS):
        return COMPLEX
    return SIMPLE
