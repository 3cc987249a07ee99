"""BufferManager: named device-buffer registry.

Parity: system/buffer.{h,cpp} — named GPU buffers with a "displayable"
flag feeding the GUI's buffer-selector dropdown. The DX12 shared-heap
interop is replaced by plain jnp device arrays plus host fetches in the
display client.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import jax.numpy as jnp

DEFAULT_FINAL_RESULT_BUFFER_NAME = "final result"  # buffer.h:46


class BufferFlag(enum.IntFlag):
    NONE = 0
    ALLOW_DISPLAY = 1


@dataclass
class BufferDesc:
    name: str
    flag: BufferFlag = BufferFlag.NONE
    width: int = 0
    height: int = 0
    stride_in_bytes: int = 0  # informational; dtype/shape carry the truth
    channels: int = 4


@dataclass
class Buffer:
    desc: BufferDesc
    array: jnp.ndarray | None = None  # (h*w, channels) or (h*w,) device array


class BufferManager:
    def __init__(self):
        self._buffers: dict[str, Buffer] = {}

    def alloc(self, desc: BufferDesc, zero: bool = True) -> Buffer:
        shape = (
            (desc.height * desc.width, desc.channels)
            if desc.channels > 1
            else (desc.height * desc.width,)
        )
        buf = Buffer(desc=desc, array=jnp.zeros(shape, jnp.float32) if zero else None)
        self._buffers[desc.name] = buf
        return buf

    def add(self, name: str, array: jnp.ndarray, flag: BufferFlag = BufferFlag.NONE,
            width: int = 0, height: int = 0) -> Buffer:
        channels = array.shape[1] if array.ndim > 1 else 1
        buf = Buffer(
            desc=BufferDesc(name=name, flag=flag, width=width, height=height,
                            channels=channels),
            array=array,
        )
        self._buffers[name] = buf
        return buf

    def set_array(self, name: str, array: jnp.ndarray) -> None:
        self._buffers[name].array = array

    def get(self, name: str) -> Buffer | None:
        return self._buffers.get(name)

    def __getitem__(self, name: str) -> Buffer:
        return self._buffers[name]

    def __contains__(self, name: str) -> bool:
        return name in self._buffers

    def displayable_names(self) -> list[str]:
        """The GUI dropdown list (buffer.cpp GetBufferNameList analog)."""
        return [
            n
            for n, b in self._buffers.items()
            if b.desc.flag & BufferFlag.ALLOW_DISPLAY
        ]

    def clear(self) -> None:
        self._buffers.clear()
