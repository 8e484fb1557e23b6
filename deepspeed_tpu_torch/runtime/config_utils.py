"""Config model base (a copy of ``deepspeed_tpu/runtime/config_utils.py``).

``DeepSpeedConfigModel`` is a pydantic base that tolerates the literal
string ``"auto"`` for any field (the field keeps its default and
``is_auto(name)`` reports it), forbids unknown keys, and copies deprecated
fields onto their replacement. ``dict_raise_error_on_duplicate_keys``,
``pp_int`` and ``ScientificNotationEncoder`` serve the training config
(``runtime/config.py``).
"""

from __future__ import annotations

import json
from typing import Any, Dict

from pydantic import BaseModel, ConfigDict, model_validator

AUTO = "auto"


class DeepSpeedConfigModel(BaseModel):
    model_config = ConfigDict(
        validate_assignment=True,
        populate_by_name=True,
        extra="forbid",
        arbitrary_types_allowed=True,
        protected_namespaces=(),
    )

    def __init__(self, strict: bool = False, **data):
        if not strict:
            auto_fields = {k for k, v in data.items() if v == AUTO}
            data = {k: v for k, v in data.items() if v != AUTO}
        else:
            auto_fields = set()
        super().__init__(**data)
        object.__setattr__(self, "_auto_fields", auto_fields)

    def is_auto(self, field_name: str) -> bool:
        return field_name in getattr(self, "_auto_fields", set())

    @model_validator(mode="before")
    @classmethod
    def _remap_deprecated(cls, values: Any) -> Any:
        if not isinstance(values, dict):
            return values
        for name, field in cls.model_fields.items():
            extra = field.json_schema_extra or {}
            if not isinstance(extra, dict) or not extra.get("deprecated"):
                continue
            if name in values and values[name] is not None:
                new_param = extra.get("new_param")
                if new_param and new_param not in values:
                    values[new_param] = values[name]
        return values

    def dict_repr(self) -> Dict[str, Any]:
        return self.model_dump()


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """JSON object-pairs hook that rejects duplicate keys (reference config.py)."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        dupes = [k for k, c in counter.items() if c > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {dupes}")
    return d


class pp_int(int):
    """Int that remembers a human-readable form for config dumps (config_utils.py:120)."""

    def __new__(cls, val: int, custom_print_str: str = None):
        inst = super().__new__(cls, val)
        inst.custom_print_str = custom_print_str
        return inst

    def __repr__(self):
        if self.custom_print_str:
            return self.custom_print_str
        return f"{int(self):_}"


class ScientificNotationEncoder(json.JSONEncoder):
    """JSON encoder emitting large numbers in scientific notation (config_utils.py:139)."""

    def iterencode(self, o, _one_shot=False):
        if isinstance(o, (int, float)) and not isinstance(o, bool) and abs(o) >= 1e4:
            return iter([f"{o:e}"])
        if isinstance(o, dict):
            parts = [f'"{k}": {"".join(self.iterencode(v))}' for k, v in o.items()]
            return iter(["{" + ", ".join(parts) + "}"])
        if isinstance(o, (list, tuple)):
            return iter(["[" + ", ".join("".join(self.iterencode(v)) for v in o) + "]"])
        return super().iterencode(o, _one_shot=_one_shot)
