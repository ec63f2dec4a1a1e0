"""Chess move validation + dynamic grammar for voice-driven chess (copy of
whisper_tpu.chessboard).

Python rebuild of the reference wchess board engine
(examples/wchess/libwchess/Chessboard.cpp, 803 LoC): spoken-command
parsing ("pawn to d4", "c1 h6", "e5"), per-piece legal-move tracking
with pins and check detection, and a GBNF grammar regenerated after
every move that admits exactly the side-to-move's currently legal
commands.  Like the reference, en passant, castling, and promotion are
not modeled (Chessboard.h:6-7), and the lazily-invalidated allowed-move
sets reproduce the reference's update discipline exactly — the
test-chessboard.cpp game scripts pass verbatim (tests/test_wchess.py).

Board indexing matches the reference: index = (digit-1)*8 + (letter-'a'),
so sorted order is a1..h1, a2..h2, …  Directions are (d_letter, d_digit).
"""

from __future__ import annotations

POSITIONS = [f"{chr(ord('a') + r)}{f + 1}" for f in range(8) for r in range(8)]

PAWN, KNIGHT, BISHOP, ROOK, QUEEN, KING = range(6)
PIECE_NAMES = ["pawn", "knight", "bishop", "rook", "queen", "king"]
WHITE, BLACK = 0, 1
_BLACK_SHORT = "pnbrqk"
_WHITE_SHORT = "PNBRQK"

# directions (d_letter, d_digit) — Chessboard.cpp:88-103
N, NNE, NE, ENE = (0, 1), (1, 2), (1, 1), (2, 1)
E, ESE, SE, SSE = (1, 0), (2, -1), (1, -1), (1, -2)
S, SSW, SW, WSW = (0, -1), (-1, -2), (-1, -1), (-2, -1)
W, WNW, NW, NNW = (-1, 0), (-2, 1), (-1, 1), (-1, 2)


def _pos(s: str) -> int | None:
    """strToPos: first two chars; None when off-board (operator ""_P)."""
    if len(s) < 2:
        return None
    r, f = ord(s[0]) - ord("a"), ord(s[1]) - ord("1")
    if 0 <= r <= 7 and 0 <= f <= 7:
        return f * 8 + r
    return None


def _type(s: str) -> int | None:
    """strToType: the spoken token may be any prefix of a piece name."""
    for i, name in enumerate(PIECE_NAMES):
        if name.startswith(s):
            return i
    return None


def _step(pos: int, d: tuple[int, int]) -> int | None:
    r, f = pos % 8 + d[0], pos // 8 + d[1]
    if 0 <= r <= 7 and 0 <= f <= 7:
        return f * 8 + r
    return None


def _traverse(pos: int, d, stop, count: int = 8) -> int | None:
    """Walk `d` from `pos` until off-board, `stop(pos)` true, or `count`."""
    while count > 0:
        count -= 1
        pos = _step(pos, d)
        if pos is None or stop(pos):
            break
    return pos


def _normalize(d: tuple[int, int]) -> tuple[int, int]:
    return ((d[0] > 0) - (d[0] < 0), (d[1] > 0) - (d[1] < 0))


def _filter(pin, directions):
    """Directions compatible with a pin ray (Chessboard.cpp:137-144)."""
    if pin == (0, 0):
        return list(directions)
    return [d for d in directions
            if (d[0] == pin[0] or d[0] == -pin[0])
            and (d[1] == pin[1] or d[1] == -pin[1])]


class Piece:
    __slots__ = ("type", "color", "pos", "allowed", "update")

    def __init__(self, ptype: int, color: int, pos: int,
                 allowed: set[int] | None = None):
        self.type = ptype
        self.color = color
        self.pos: int | None = pos
        self.allowed: set[int] = set(allowed or ())
        self.update = False

    # ---- movePattern (geometry only, blind to occupancy) ------------------

    def move_pattern(self, pos: int) -> bool:
        if self.pos is None:
            return False
        cr, cf = self.pos % 8, self.pos // 8
        nr, nf = pos % 8, pos // 8
        dr, df = nr - cr, nf - cf
        t = self.type
        if t == PAWN:
            fwd = -1 if self.color else 1
            return ((df == fwd and dr * dr <= 1)
                    or (self._first_move() and df == 2 * fwd and dr == 0))
        if t == KNIGHT:
            return dr * dr + df * df == 5
        if t == BISHOP:
            return cr - cf == nr - nf or cr + cf == nr + nf
        if t == ROOK:
            return cr == nr or cf == nf
        if t == QUEEN:
            return (cr == nr or cf == nf
                    or cr - cf == nr - nf or cr + cf == nr + nf)
        return dr * dr + df * df <= 2    # KING

    def _first_move(self) -> bool:
        return self.pos // 8 == (6 if self.color else 1)

    def can_reach(self, pos: int) -> bool:
        return self.move_pattern(pos) and pos in self.allowed

    def take(self) -> None:
        self.pos = None
        self.allowed = set()

    def coord(self) -> str:
        return "" if self.pos is None else POSITIONS[self.pos]

    def initial(self) -> str:
        return (_BLACK_SHORT if self.color else _WHITE_SHORT)[self.type]

    # ---- allowed-set recompute (lazy, pin-aware) --------------------------

    def reinit(self, state: "_State") -> None:
        if self.pos is None or not self.update:
            return
        self.update = False
        self.allowed = set()
        board = state.board
        pin = state.find_pin(self)
        t = self.type

        if t == PAWN:
            left, right = (SW, SE) if self.color else (NW, NE)
            for d in _filter(pin, (left, right)):
                p = _step(self.pos, d)
                if (p is not None and board[p]
                        and board[p].color != self.color):
                    self.allowed.add(p)
            if _filter(pin, (S if self.color else N,)):
                def stop(p):
                    if not board[p]:
                        self.allowed.add(p)
                    return bool(board[p]) or not self._first_move()
                _traverse(self.pos, S if self.color else N, stop, 2)
        elif t == KNIGHT:
            if pin != (0, 0):
                return
            for d in (NNE, ENE, ESE, SSE, SSW, WSW, WNW, NNW):
                p = _step(self.pos, d)
                if (p is not None
                        and (not board[p] or board[p].color != self.color)):
                    self.allowed.add(p)
        elif t in (BISHOP, ROOK, QUEEN):
            dirs = {BISHOP: (NE, SE, SW, NW), ROOK: (N, E, S, W),
                    QUEEN: (N, NE, E, SE, S, SW, W, NW)}[t]
            for d in _filter(pin, dirs):
                _traverse(self.pos, d, self._add(board))
        else:   # KING: exclude squares attacked by any enemy piece
            enemies = state.whites if self.color else state.blacks
            atk_l, atk_r = (SW, SE) if self.color else (NW, NE)
            for d in (N, NE, E, SE, S, SW, W, NW):
                p = _step(self.pos, d)
                if p is None or (board[p] and board[p].color == self.color):
                    continue
                accept = True
                for e in enemies:
                    if not e.move_pattern(p):
                        continue
                    if e.type in (KNIGHT, KING):
                        accept = False
                        break
                    if e.type == PAWN:
                        er, ef = e.pos % 8, e.pos // 8
                        d2 = (er - p % 8, ef - p // 8)
                        if d2 == atk_l or d2 == atk_r:
                            accept = False
                            break
                    else:
                        d2 = _normalize((e.pos % 8 - p % 8,
                                         e.pos // 8 - p // 8))
                        reached = _traverse(p, d2, lambda q: bool(board[q]))
                        if reached == e.pos:
                            accept = False
                            break
                if accept:
                    self.allowed.add(p)

    def _add(self, board):
        def stop(p):
            if not board[p] or board[p].color != self.color:
                self.allowed.add(p)
            return bool(board[p])
        return stop


def _piece_set(color: int) -> list[Piece]:
    """PieceSet member order (Chessboard.cpp:282-307 + State()):
    8 pawns then r,n,b,q,k,b,n,r with the hardcoded initial moves."""
    back = 7 if color else 0
    pawn_rank = 6 if color else 1
    step1, step2 = (5, 4) if color else (2, 3)
    pieces = []
    for r in range(8):
        pieces.append(Piece(PAWN, color, pawn_rank * 8 + r,
                            {step1 * 8 + r, step2 * 8 + r}))
    knight_jump = 5 if color else 2
    layout = [(ROOK, 0, None), (KNIGHT, 1, (0, 2)), (BISHOP, 2, None),
              (QUEEN, 3, None), (KING, 4, None), (BISHOP, 5, None),
              (KNIGHT, 6, (5, 7)), (ROOK, 7, None)]
    for ptype, r, jumps in layout:
        allowed = ({knight_jump * 8 + j for j in jumps} if jumps else None)
        pieces.append(Piece(ptype, color, back * 8 + r, allowed))
    return pieces


class _State:
    def __init__(self):
        self.whites = _piece_set(WHITE)
        self.blacks = _piece_set(BLACK)
        self.board: list[Piece | None] = [None] * 64
        for p in self.whites + self.blacks:
            self.board[p.pos] = p
        self.white_pins: list[tuple] = []   # (direction, pinner, pinned)
        self.black_pins: list[tuple] = []

    def find_pin(self, piece: Piece) -> tuple[int, int]:
        pins = self.black_pins if piece.color else self.white_pins
        for d, _pinner, pinned in pins:
            if pinned is piece:
                return d
        return (0, 0)


class Chessboard:
    """process() validates a spoken command and returns "from-to" ("" when
    illegal, trailing "#" when the game ends); grammar() is the GBNF for
    the side to move (empty when no legal move remains)."""

    def __init__(self):
        self._state = _State()
        self._allowed_in_check: set[int] = set()
        self._in_check = False
        self._move_counter = 0
        self._grammar = ""
        self._prompt = ""
        self._set_grammar()

    def grammar(self) -> str:
        return self._grammar

    def prompt(self) -> str:
        return self._prompt

    def set_prompt(self, prompt: str) -> None:
        self._prompt = prompt
        self._set_grammar()

    # ---- command processing (Chessboard.cpp:629-656) ----------------------

    def process(self, command: str) -> str:
        parsed = self._parse_command(command)
        if parsed is None:
            return ""
        piece, pos_to = parsed
        pos_from = piece.pos
        if not self._move(piece, pos_to):
            return ""
        self._flag_updates(pos_from, pos_to)
        self._detect_checks()
        color = self._move_counter % 2
        enemies = (self._state.whites if color else self._state.blacks)
        for p in enemies:      # only the side to move next needs fresh sets
            p.reinit(self._state)
        result = f"{POSITIONS[pos_from]}-{POSITIONS[pos_to]}"
        self._move_counter += 1
        self._set_grammar()
        if not self._grammar:
            result += "#"
        return result

    def _parse_command(self, command: str):
        color = self._move_counter % 2
        if not command:
            return None
        tokens = command.split()
        if not tokens:
            return None
        pos_from, ptype = None, None
        if len(tokens) == 1:
            ptype = PAWN
            pos_to = _pos(tokens[0])
        else:
            pos_from = _pos(tokens[0])
            if pos_from is None:
                ptype = _type(tokens[0])
            pos_to = _pos(tokens[-1])
        if pos_to is None:
            return None
        if pos_from is None:
            if ptype is None:
                return None
            pieces = self._state.blacks if color else self._state.whites
            for p in pieces:
                if p.type == ptype and p.can_reach(pos_to):
                    pos_from = p.pos
                    break
        if pos_from is None:
            return None
        piece = self._state.board[pos_from]
        if piece is None or piece.color != color:
            return None
        return piece, pos_to

    def _move(self, piece: Piece, pos_to: int) -> bool:
        if (pos_to not in piece.allowed
                or (self._in_check and piece.type != KING
                    and pos_to not in self._allowed_in_check)):
            return False
        board = self._state.board
        target = board[pos_to]
        if target and target.color == piece.color:
            return False
        if target:
            target.take()
        board[piece.pos] = None
        board[pos_to] = piece
        piece.pos = pos_to
        piece.update = True
        self._in_check = False
        self._allowed_in_check = set()
        return True

    def _flag_updates(self, pos_from: int, pos_to: int) -> None:
        color = self._move_counter % 2      # the mover (counter not yet ++)
        enemies = self._state.whites if color else self._state.blacks
        own = self._state.blacks if color else self._state.whites
        for p in list(enemies) + list(own):
            if p.move_pattern(pos_to) or p.move_pattern(pos_from):
                self._update_pins(p)
                p.update = True

    def _update_pins(self, piece: Piece) -> None:
        if piece.type in (PAWN, KNIGHT, KING):
            return
        state = self._state
        enemies = state.whites if piece.color else state.blacks
        enemy_pins = state.white_pins if piece.color else state.black_pins
        king = enemies[12]     # PieceSet slot: 8 pawns + r,n,b,q then k
        for i, (_d, pinner, pinned) in enumerate(enemy_pins):
            if pinner is piece:
                pinned.update = True
                del enemy_pins[i]
                break
        if king.pos is None:   # king captured through a stale allowed set
            return
        if piece.move_pattern(king.pos):
            d = _normalize((king.pos % 8 - piece.pos % 8,
                            king.pos // 8 - piece.pos // 8))
            board = state.board
            reached = _traverse(piece.pos, d, lambda q: bool(board[q]))
            found = board[reached] if reached is not None else None
            if found is king:
                king.update = True      # check
            elif found and found.color != piece.color:
                reached = _traverse(reached, d, lambda q: bool(board[q]))
                if reached is not None and board[reached] is king:
                    enemy_pins.append((d, piece, found))
                    found.update = True

    def _detect_checks(self) -> None:
        state = self._state
        color = self._move_counter % 2
        enemies = state.whites if color else state.blacks
        own = state.blacks if color else state.whites
        king = enemies[12]
        if king.pos is None:   # king captured through a stale allowed set
            return
        atk_l, atk_r = (SW, SE) if color else (NW, NE)
        for p in own:
            if not p.move_pattern(king.pos):
                continue
            if p.type == KNIGHT:
                self._enter_check({p.pos})
            elif p.type == PAWN:
                d = (king.pos % 8 - p.pos % 8, king.pos // 8 - p.pos // 8)
                if d == atk_l or d == atk_r:
                    self._enter_check({p.pos})
            elif p.type != KING:
                d = _normalize((king.pos % 8 - p.pos % 8,
                                king.pos // 8 - p.pos // 8))
                tmp: set[int] = set()
                board = state.board

                def stop(q):
                    if not board[q] or board[q].color != king.color:
                        tmp.add(q)
                    return bool(board[q])
                pos = _traverse(p.pos, d, stop)
                if pos == king.pos:
                    tmp.add(p.pos)
                    self._enter_check(tmp)

    def _enter_check(self, allowed: set[int]) -> None:
        # double check leaves only king moves (Chessboard.cpp:741-776)
        self._allowed_in_check = set() if self._in_check else allowed
        self._in_check = True

    # ---- grammar generation (Chessboard.cpp:546-607) -----------------------

    def _set_grammar(self) -> None:
        self._grammar = ""
        if not self._prompt:
            result = 'move ::= " " ((piece | frompos) " " "to "?)? topos\n'
        else:
            result = ('move ::= prompt " " frompos " " "to "? topos\n'
                      'prompt ::= " ' + self._prompt + '"\n')

        piece_types: set[int] = set()
        from_pos: set[int] = set()
        to_pos: set[int] = set()
        pieces = (self._state.blacks if self._move_counter % 2
                  else self._state.whites)
        for p in pieces:
            if not p.allowed:
                continue
            add_piece = False
            if not self._in_check or p.type == KING:
                to_pos.update(p.allowed)
                add_piece = True
            else:
                for move in p.allowed:
                    if move in self._allowed_in_check:
                        to_pos.add(move)
                        add_piece = True
            if add_piece:
                piece_types.add(p.type)
                from_pos.add(p.pos)
        if not piece_types:
            return

        result += "piece ::= ("
        for t in sorted(piece_types):
            result += f' "{PIECE_NAMES[t]}" |'
        result = result[:-1] + ")\n\n"
        result += "frompos ::= ("
        for p in sorted(from_pos):
            result += f' "{POSITIONS[p]}" |'
        result = result[:-1] + ")\n"
        result += "topos ::= ("
        for p in sorted(to_pos):
            result += f' "{POSITIONS[p]}" |'
        result = result[:-1] + ")\n"
        self._grammar = result

    def stringify_board(self) -> str:
        out = []
        out.append(" ".join(chr(ord("a") + r) for r in range(8)) + "\n")
        for f in range(7, -1, -1):
            row = []
            for r in range(8):
                p = self._state.board[f * 8 + r]
                row.append(p.initial() if p else ("." if (f + r) % 2 else "*"))
            out.append(" ".join(row) + f" {f + 1}\n")
        return "".join(out)
