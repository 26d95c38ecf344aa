"""The arithmetic a reference computes in.

``Precision('f64')`` computes in float64. ``Precision('bf16')`` is the
control: float32 arithmetic whose inputs and stage results are rounded to
bfloat16 (8 bits of mantissa), the nearest precision below the float32 that
the configurations state.
"""

import torch


class Precision:
    def __init__(self, name='f64'):
        if name not in ('f64', 'bf16'):
            raise ValueError(f'unknown precision {name!r}')
        self.name = name
        self.dtype = torch.float64 if name == 'f64' else torch.float32
        self.cdtype = torch.complex128 if name == 'f64' else torch.complex64

    def __call__(self, t):
        """`t` in the working type, rounded to bfloat16 for the control."""
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t, dtype=torch.float64)
        if t.is_complex():
            t = t.to(self.cdtype)
            if self.name == 'bf16':
                t = torch.complex(self(t.real), self(t.imag))
            return t
        t = t.to(self.dtype)
        if self.name == 'bf16':
            t = t.to(torch.bfloat16).to(torch.float32)
        return t

    def __repr__(self):
        return f'Precision({self.name!r})'
