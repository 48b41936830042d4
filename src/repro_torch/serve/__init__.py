"""The port's serving layer (the counterpart of ``repro.serve``): the vector
service and its engine, with every plane the reference has -- micro-batching
and admission, the dispatch lanes, tracing and the labeled registry, the
adaptive policy, continuation tokens and the declarative predicates. The LM
serving engine (``repro.serve.engine``) belongs to the LM stack and is not
ported here.
"""
from .continuation import (ContinuationError, decode_continuation,
                           encode_continuation)
from .metrics import (EngineMetrics, ExactHistogram, Histogram, SimClock,
                      poisson_arrivals)
from .obs import MetricsRegistry, RollupWindow
from .policy import (AdaptivePolicy, ControlPolicy, PolicyDecision,
                     PolicySignals, StaticPolicy, make_policy)
from .predicate import F, Predicate, from_obj, property_items
from .trace import (FlightRecorder, Span, Trace, Tracer,
                    validate_trace_record)
from .vector_engine import (EngineConfig, ServeRequest, ServeResponse,
                            Throttled, VectorServeEngine)
from .vector_service import (DeadlineExceeded, QueryResult,
                             VectorCollectionService, VectorQuery)

__all__ = [
    "VectorCollectionService", "VectorQuery", "QueryResult",
    "VectorServeEngine", "EngineConfig", "ServeRequest", "ServeResponse",
    "Throttled", "DeadlineExceeded",
    "EngineMetrics", "SimClock", "poisson_arrivals",
    "Histogram", "ExactHistogram", "MetricsRegistry", "RollupWindow",
    "ControlPolicy", "AdaptivePolicy", "StaticPolicy", "PolicyDecision",
    "PolicySignals", "make_policy",
    "Span", "Trace", "Tracer", "FlightRecorder", "validate_trace_record",
    "ContinuationError", "encode_continuation", "decode_continuation",
    "F", "Predicate", "from_obj", "property_items",
]
