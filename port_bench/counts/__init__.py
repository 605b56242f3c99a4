"""Operations and bytes of the program's work, counted from the shapes of
the inputs and the configuration, never from what an implementation
happens to execute: a later change to the program cannot move them."""
