"""IEC 61131-3 Structured Text export backend (the paper's PLC target),
the counterpart of ``repro.codegen``.

``st`` emits a trained, quantized detector as one self-contained
FUNCTION_BLOCK; ``emulator`` executes the emitted subset with PLC-faithful
semantics; ``verify`` replays scenario windows through both the block and
the serving engine and holds them to the bit-exact (SINT) / epsilon (REAL)
contract.
"""

from repro_torch.codegen.emulator import (STError, STFunctionBlock,
                                          STRuntimeError, STSyntaxError,
                                          STTypeError, parse_function_block)
from repro_torch.codegen.st import (STContext, STExport, STExportError,
                                    STWriter, export_st, format_real)
from repro_torch.codegen.verify import (emulate_stream, normalize_windows,
                                        numpy_mlp_ref, run_engine,
                                        sequential_f32_mse, stream_windows,
                                        verify_export, window_starts)

__all__ = [
    "STError", "STFunctionBlock", "STRuntimeError", "STSyntaxError",
    "STTypeError", "parse_function_block",
    "STContext", "STExport", "STExportError", "STWriter", "export_st",
    "format_real",
    "emulate_stream", "normalize_windows", "numpy_mlp_ref",
    "run_engine",
    "sequential_f32_mse", "stream_windows", "verify_export",
    "window_starts",
]
