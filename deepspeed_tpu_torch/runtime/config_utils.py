"""Config model base (a copy of ``deepspeed_tpu/runtime/config_utils.py``).

``DeepSpeedConfigModel`` is a pydantic base that tolerates the literal
string ``"auto"`` for any field (the field keeps its default and
``is_auto(name)`` reports it), forbids unknown keys, and copies deprecated
fields onto their replacement.
"""

from __future__ import annotations

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
