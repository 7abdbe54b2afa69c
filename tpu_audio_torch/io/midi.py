"""MIDI byte-stream framing and control-change parsing (port of
tpu_audio/io/midi.py).

Capability equivalent of the reference's raw MIDI reader (reference
src/midi.cu:3-59): reconstructs complete MIDI messages from an unframed byte
stream, including *running status* (a data byte arriving with an empty
message buffer re-uses the last seen status byte, src/midi.cu:53-55), and
validates framing before dispatch (src/midi.cu:3-20: channel voice messages
0x80/0x90/0xA0/0xB0 are complete at 3 bytes; 0xF0-family messages complete at
a 0xF7 terminator).

Where the reference asserts (aborts the process) on an unexpected leading
byte (src/midi.cu:18), the framer logs a warning and resynchronises — a
real-time server must not die on line noise.

Transport is separate: this module is pure parsing; byte sources (FIFOs,
device files, the C framer of csrc/blockio.cpp) live in
tpu_audio_torch.runtime.
"""

from __future__ import annotations

from tpu_audio_torch.utils.log import Log

# Channel voice messages handled by the reference framer (src/midi.cu:6-12).
_THREE_BYTE_STATUS = (0x80, 0x90, 0xA0, 0xB0)
# Full MIDI framing (extension): 0xC0/0xD0 are 2-byte messages, 0xE0 is 3-byte.
_TWO_BYTE_STATUS = (0xC0, 0xD0)

CC_STATUS = 0xB0  # control change


def is_valid_message(buf: bytes) -> bool:
    """Reference framing check (src/midi.cu:3-20), extended to 0xC0/0xD0/0xE0."""
    if not buf:
        return False
    hi = buf[0] & 0xF0
    if hi in _THREE_BYTE_STATUS or hi == 0xE0:
        return len(buf) == 3
    if hi in _TWO_BYTE_STATUS:
        return len(buf) == 2
    if hi == 0xF0:
        # SysEx runs to its 0xF7 terminator; system COMMON messages have
        # fixed lengths (F1 MTC quarter-frame 2, F2 song position 3, F3
        # song select 2; F4/F5 undefined and F6 tune request / stray F7
        # are single bytes), so an MTC quarter-frame never swallows the
        # running-status data bytes that follow it.
        if buf[0] == 0xF0:
            return buf[-1] == 0xF7
        if buf[0] == 0xF2:
            return len(buf) == 3
        if buf[0] in (0xF1, 0xF3):
            return len(buf) == 2
        return len(buf) == 1
    return False


class MidiFramer:
    """Incremental framer: feed() raw bytes, get back complete messages."""

    def __init__(self, strict: bool = False):
        self.running_status = 0
        self.strict = strict
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[bytes]:
        """Consume a chunk of raw bytes; return the complete messages in it."""
        messages: list[bytes] = []
        for byte in data:
            if byte >= 0xF8:
                # System realtime (clock/start/stop/active-sense): single-byte
                # messages, transparent to running status and to any message
                # currently being assembled, as the MIDI spec says (the
                # reference would clobber its running status here,
                # src/midi.cu:53; controllers interleave 0xF8 clock bytes)
                messages.append(bytes([byte]))
                continue
            if byte & 0x80:
                # status byte: a channel voice status becomes running
                # status and starts the message (reference src/midi.cu:
                # 53-56); SysEx and system common CLEAR running status
                # (MIDI spec), so a later stray data byte cannot open a
                # phantom SysEx
                hi = byte & 0xF0
                if hi != 0xF0:
                    self.running_status = byte
                else:
                    self.running_status = 0
                if self._buf and byte == 0xF7 and self._buf[0] == 0xF0:
                    self._buf.append(byte)  # SysEx terminator
                else:
                    if self._buf and not self.strict:
                        Log.warn("midi", "dropping %d unframed byte(s)",
                                 len(self._buf))
                    self._buf = bytearray([byte])
            else:
                if not self._buf:
                    if not self.running_status:
                        if self.strict:
                            raise ValueError(f"unexpected midi byte {byte:#04x}")
                        Log.warn("midi", "unexpected midi byte: %02x", byte)
                        continue
                    self._buf.append(self.running_status)
                self._buf.append(byte)

            if is_valid_message(bytes(self._buf)):
                messages.append(bytes(self._buf))
                self._buf = bytearray()
        return messages


def parse_cc(message: bytes) -> tuple[int, int, int] | None:
    """Return (status, controller, value) for a 3-byte CC message, else None."""
    if len(message) == 3 and (message[0] & 0xF0) == CC_STATUS:
        return message[0], message[1], message[2]
    return None


def cc_bytes(channel: int, controller: int, value: int) -> bytes:
    """Build a control-change message (for tests and scripted param streams)."""
    return bytes([CC_STATUS | (channel & 0x0F), controller & 0x7F, value & 0x7F])
