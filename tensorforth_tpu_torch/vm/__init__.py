from .vm import VM, VMState, vm_factory  # noqa: F401
