#!/bin/bash
# Interactive CLI wizard for beatmap generation on the PyTorch/CUDA port — walks
# through every option `python -m mapperatorinator_tpu_torch.inference` accepts
# and runs it with the corresponding overrides (the repo's cli_inference.sh, with
# the port's entry point). Run it from anywhere:
#     bash mapperatorinator_tpu_torch/cli_inference.sh
# The model presets are the repo's configs/inference/*.yaml but the default.
set -e

BOLD=$'\033[1m'; CYAN=$'\033[0;36m'; GREEN=$'\033[0;32m'; YELLOW=$'\033[0;33m'; NC=$'\033[0m'
cd "$(dirname "$0")/.."  # the repo root, where the port's package and configs/ lie

header() { echo; echo "${CYAN}== $1 ==${NC}"; }
note()   { echo "${YELLOW}$1${NC}"; }

ask() { # ask "prompt" default varname
    local input
    if [ -n "$2" ]; then
        read -e -p "${GREEN}$1${NC} [$2]: " input
        printf -v "$3" '%s' "${input:-$2}"
    else
        read -e -p "${GREEN}$1${NC}: " input
        printf -v "$3" '%s' "$input"
    fi
}

ask_yn() { # ask_yn "prompt" default(y/n) varname -> "true"/"false"
    local yn
    while true; do
        if [ "$2" = "y" ]; then
            read -p "${GREEN}$1${NC} [Y/n]: " yn; yn=${yn:-y}
        else
            read -p "${GREEN}$1${NC} [y/N]: " yn; yn=${yn:-n}
        fi
        case $yn in
            [Yy]*) printf -v "$3" 'true'; return;;
            [Nn]*) printf -v "$3" 'false'; return;;
            *) echo "Please answer y or n.";;
        esac
    done
}

ask_choice() { # ask_choice "prompt" default varname option...
    local prompt=$1 default=$2 var=$3; shift 3
    local options=("$@") i choice
    echo "${GREEN}$prompt${NC}"
    for i in "${!options[@]}"; do
        echo "  $((i+1))) ${options[i]}"
    done
    while true; do
        read -p "Select option (1-${#options[@]}) [default: $default]: " choice
        choice=${choice:-$default}
        if [[ "$choice" =~ ^[0-9]+$ ]] && [ "$choice" -ge 1 ] && [ "$choice" -le ${#options[@]} ]; then
            break
        fi
        echo "Please enter a number between 1 and ${#options[@]}."
    done
    printf -v "$var" '%s' "${options[$((choice-1))]}"
}

OVERRIDES=()
add() { OVERRIDES+=("$1"); }          # add key=value
add_if() { [ -n "$2" ] && add "$1=$2" || true; }  # only when non-empty

echo "${BOLD}Mapperatorinator (PyTorch/CUDA port) — interactive inference wizard${NC}"

# ---------------------------------------------------------------------------
header "Model"
mapfile -t PRESETS < <(cd configs/inference && printf '%s\n' *.yaml | LC_ALL=C sort | sed 's/\.yaml$//' | grep -vx default)
DEFAULT_PRESET=${#PRESETS[@]}
for i in "${!PRESETS[@]}"; do [ "${PRESETS[i]}" = v32 ] && DEFAULT_PRESET=$((i+1)); done
ask_choice "Model preset:" "$DEFAULT_PRESET" CONFIG "${PRESETS[@]}"
ask "Model path (checkpoint dir; empty = preset default)" "" MODEL_PATH
add_if model_path "$MODEL_PATH"
ask "LoRA adapter path (optional)" "" LORA_PATH
add_if lora_path "$LORA_PATH"
ask_yn "Use bf16 precision?" y BF16
[ "$BF16" = "true" ] && add "precision=bf16"
ask_yn "Use the shared inference server (multi-process batching)?" n USE_SERVER
add "use_server=$USE_SERVER"

# ---------------------------------------------------------------------------
header "Input / output"
ask "Audio path (.mp3/.ogg/.wav)" "" AUDIO_PATH
[ -z "$AUDIO_PATH" ] && { echo "audio path is required"; exit 1; }
add "audio_path=$AUDIO_PATH"
ask "Output directory" "./output" OUTPUT_PATH
add "output_path=$OUTPUT_PATH"
ask "Reference beatmap .osu (metadata autofill / context; optional)" "" BEATMAP_PATH
add_if beatmap_path "$BEATMAP_PATH"

# ---------------------------------------------------------------------------
header "Beatmap settings"
ask_choice "Gamemode:" 1 GAMEMODE_NAME "standard (0)" "taiko (1)" "catch (2)" "mania (3)"
GAMEMODE=$(echo "$GAMEMODE_NAME" | grep -o '[0-9]')
add "gamemode=$GAMEMODE"
ask "Difficulty (star rating, e.g. 5.5; empty = from reference map)" "" DIFFICULTY
add_if difficulty "$DIFFICULTY"
ask "Mapper ID (style conditioning; optional)" "" MAPPER_ID
add_if mapper_id "$MAPPER_ID"
ask "Year (2007-2023 style; optional)" "" YEAR
add_if year "$YEAR"
ask_yn "Generate hitsounds?" y HITSOUNDED
add "hitsounded=$HITSOUNDED"

ask "HP drain rate (optional)" "" HP;   add_if hp_drain_rate "$HP"
ask "Circle size CS (optional)" "" CS;  add_if circle_size "$CS"
ask "Overall difficulty OD (optional)" "" OD; add_if overall_difficulty "$OD"
ask "Approach rate AR (optional)" "" AR; add_if approach_rate "$AR"
ask "Slider multiplier (optional)" "" SM; add_if slider_multiplier "$SM"
ask "Slider tick rate (optional)" "" STR2; add_if slider_tick_rate "$STR2"

if [ "$GAMEMODE" = "3" ]; then
    header "Mania"
    ask "Key count" "4" KEYCOUNT
    add "keycount=$KEYCOUNT"
    ask "Hold note ratio 0-1 (optional)" "" HNR
    add_if hold_note_ratio "$HNR"
fi
if [ "$GAMEMODE" = "1" ] || [ "$GAMEMODE" = "3" ]; then
    ask "Scroll speed ratio 0-1 (optional)" "" SSR
    add_if scroll_speed_ratio "$SSR"
fi

# ---------------------------------------------------------------------------
header "Style descriptors"
note "Comma-separated names, e.g.: clean,symmetrical (empty = none)"
ask "Descriptors" "" DESCRIPTORS
if [ -n "$DESCRIPTORS" ]; then
    add "descriptors=[$(echo "$DESCRIPTORS" | sed 's/ *, */,/g')]"
fi
ask "Negative descriptors (needs cfg_scale > 1)" "" NEG_DESCRIPTORS
if [ -n "$NEG_DESCRIPTORS" ]; then
    add "negative_descriptors=[$(echo "$NEG_DESCRIPTORS" | sed 's/ *, */,/g')]"
fi

# ---------------------------------------------------------------------------
header "Sampling"
ask "CFG scale (1.0 = off)" "1.0" CFG_SCALE
add "cfg_scale=$CFG_SCALE"
ask "Temperature" "0.9" TEMPERATURE
add "temperature=$TEMPERATURE"
ask "Top-p" "0.9" TOP_P
add "top_p=$TOP_P"
ask "Seed (empty = random)" "" SEED
add_if seed "$SEED"
ask_yn "Super timing (slow, ensemble timing generation)?" n SUPER_TIMING
add "super_timing=$SUPER_TIMING"
ask_yn "Generate positions with the diffusion model?" n GEN_POS
add "generate_positions=$GEN_POS"

# ---------------------------------------------------------------------------
if [ -n "$BEATMAP_PATH" ]; then
    header "Reference beatmap context"
    note "Context types give the model parts of the reference map as input."
    ask_yn "Use its TIMING as context?" n CTX_TIMING
    ask_yn "Use its MAP (hit objects) as context (guest difficulty)?" n CTX_GD
    ask_yn "Use its KIAI as context?" n CTX_KIAI
    ask_yn "Use its SV as context?" n CTX_SV
    CONTEXTS=()
    [ "$CTX_TIMING" = "true" ] && CONTEXTS+=("timing")
    [ "$CTX_GD" = "true" ] && CONTEXTS+=("gd")
    [ "$CTX_KIAI" = "true" ] && CONTEXTS+=("kiai")
    [ "$CTX_SV" = "true" ] && CONTEXTS+=("sv")
    if [ ${#CONTEXTS[@]} -gt 0 ]; then
        add "in_context=[$(IFS=,; echo "${CONTEXTS[*]}")]"
    fi
    ask_yn "Add generated content INTO the reference beatmap?" n ADD_TO
    add "add_to_beatmap=$ADD_TO"
    if [ "$ADD_TO" = "true" ]; then
        ask_yn "Overwrite the reference beatmap file?" n OVERWRITE
        add "overwrite_reference_beatmap=$OVERWRITE"
    fi
fi

# ---------------------------------------------------------------------------
header "Time window"
ask "Start time in ms (empty = song start)" "" START_TIME
add_if start_time "$START_TIME"
ask "End time in ms (empty = song end)" "" END_TIME
add_if end_time "$END_TIME"

# ---------------------------------------------------------------------------
header "Metadata"
ask "Title (empty = autofill)" "" TITLE;     add_if title "$TITLE"
ask "Artist (empty = autofill)" "" ARTIST;   add_if artist "$ARTIST"
ask "Creator" "" CREATOR;                    add_if creator "$CREATOR"
ask "Difficulty name (version)" "" VERSION;  add_if version "$VERSION"
ask "Source" "" SOURCE;                      add_if source "$SOURCE"
ask "Tags" "" TAGS;                          add_if tags "$TAGS"
ask "Background image path (optional)" "" BG; add_if background "$BG"
ask_yn "Export as .osz archive?" n EXPORT_OSZ
add "export_osz=$EXPORT_OSZ"

# ---------------------------------------------------------------------------
header "Command"
CMD=(python -m mapperatorinator_tpu_torch.inference -cn "$CONFIG" "${OVERRIDES[@]}")
echo "${BOLD}${CMD[*]}${NC}"
ask_yn "Run it now?" y RUN_NOW
if [ "$RUN_NOW" = "true" ]; then
    "${CMD[@]}"
else
    echo "Command printed above — run it whenever you're ready."
fi
