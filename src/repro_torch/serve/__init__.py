"""The port's serving layer (the counterpart of ``repro.serve``): so far only
the declarative predicate API, which the filtered fan-out compiles against
each partition's property-term postings. The engines and the service wait
for their own slice.
"""
from .predicate import F, Predicate, from_obj, property_items

__all__ = ["F", "Predicate", "from_obj", "property_items"]
