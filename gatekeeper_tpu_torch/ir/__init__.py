from .compile import Uncompilable, compile_template
from .prog import Program

__all__ = ["CompiledTemplate", "Program", "TorchDriver", "Uncompilable",
           "compile_template"]


def __getattr__(name):
    # the driver and evaluator load on first use: the kernels import the
    # IR (ir.prog), and the evaluator imports the kernels
    if name == "TorchDriver":
        from .driver import TorchDriver
        return TorchDriver
    if name == "CompiledTemplate":
        from .evaltorch import CompiledTemplate
        return CompiledTemplate
    raise AttributeError(name)
