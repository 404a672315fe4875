"""Operations and bytes that a step or a kernel needs, as functions of
shapes and of the real edge count, and the card's published peaks."""
